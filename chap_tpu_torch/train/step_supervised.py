"""Supervised baseline train step: 0.5 * (CE + dice) on each decoder output
(port of chap_tpu/train/step_supervised.py:21-53, the trainer's
``supervised`` mode).

The reference's fully-supervised protocol (train_share_encoder_2D.py:
322-327) on the dual-decoder model: one train-mode pass, the loss of each
of its two outputs through K1 with one region (``dice_ce_supervised``: one
forward and one backward launch each, so 2 + 2 a step), one SGD update, and
the pass's batch statistics folded into the BN running stats. The dropout
draws are made up front as in step_chap.py, so a test can feed chap_tpu's.

With W > 1 ranks (parallel/dist.py) each rank takes a contiguous 1/W of the
global batch (W must divide it), the draws are those of the global batch,
and the step is the one-process step over it: K1's statistics and the BN
statistics are global and the gradients are summed over the ranks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.state import TrainState, fold_batch_stats, make_lr_schedule
from chap_tpu_torch.train.step_chap import (StepOutput, dropout_draws,
                                            uniform_sampler)


def draw_supervised_uniforms(cfg: Config, image_shape: Sequence[int],
                             generator: Optional[torch.Generator] = None,
                             device: Optional[Union[str, torch.device]] = None,
                             decoders: int = 2) -> Dict[str, object]:
    """{'drop': step_chap.dropout_draws over the batch's B rows} for a model
    with ``decoders`` outputs, drawn as step_chap.uniform_sampler says."""
    b, _, *spatial = (int(s) for s in image_shape)
    rand, _ = uniform_sampler(generator, device)
    return {"drop": dropout_draws(cfg, b, spatial, rand, decoders)}


def build_supervised_train_step(model: torch.nn.Module,
                                optimizer: torch.optim.Optimizer, cfg: Config,
                                device: Optional[Union[str, torch.device]] = None):
    """Returns ``step(state, batch, generator=None, draws=None) ->
    StepOutput`` for a dual-decoder model; batch and draws as in
    step_chap.build_chap_train_step. Metrics: {'loss'} as a 0-d device
    tensor."""
    device = resolve_device(device)
    num_classes = cfg.data.num_classes
    world = dist.world_size()
    dist.check_rows(cfg.data.batch_size, 1, world, "supervised step")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, the "
                         f"step on {device}")
    lr_schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                   cfg.optim.poly_power)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, object]] = None) -> StepOutput:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state holds another model or optimizer than "
                             "the step was built for")
        image = batch["image"]
        label = batch["label"].to(torch.int32)
        if world > 1 and image.shape[0] * world != cfg.data.batch_size:
            raise ValueError(f"batch of {image.shape[0]} rows; this rank "
                             f"takes {cfg.data.batch_size // world} "
                             f"(batch_size {cfg.data.batch_size} over {world} "
                             f"ranks)")
        if draws is None:
            draws = draw_supervised_uniforms(
                cfg, (image.shape[0] * world,) + tuple(image.shape[1:]),
                generator, image.device)
        drop_u = [dist.shard_rows(u) for u in draws["drop"]]
        model.train()
        stats: Dict = {}
        o1, o2 = model(image, drop_u=drop_u, stats=stats)
        loss = (dice_ce_supervised(o1, label, num_classes)
                + dice_ce_supervised(o2, label, num_classes))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        dist.all_reduce_grads(model.parameters())
        for group in optimizer.param_groups:
            group["lr"] = lr_schedule(state.step)
        optimizer.step()
        fold_batch_stats(model, [stats])
        state.step += 1
        return StepOutput(state, {"loss": loss.detach()})

    return step
