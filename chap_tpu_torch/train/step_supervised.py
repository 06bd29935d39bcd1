"""Supervised baseline train step: 0.5 * (CE + dice) on each decoder output
(port of chap_tpu/train/step_supervised.py:21-53; on the dual-decoder model
the trainer's ``supervised`` mode).

The reference's fully-supervised protocol (train_share_encoder_2D.py:
322-327): one train-mode pass, the loss of each output through K1 with one
region (``dice_ce_supervised``: one forward and one backward launch each),
one SGD update, and the pass's batch statistics folded into the BN running
stats. The dual-decoder model sums its two losses (2 + 2 launches a step;
chap_tpu's ``dual=True``); any other model must return logits alone from
its train-mode pass (unet, resunet, swinunet, enet, pnet, efficient_unet:
1 + 1 launches a step; chap_tpu's ``dual=False``), and a pass that returns
several outputs is refused, as chap_tpu's step fails on it. The dropout
draws are made up front as in step_chap.py (for a model of one output at
its own ``dropout_shapes``), so a test can feed chap_tpu's.

With W > 1 ranks (parallel/dist.py) each rank takes a contiguous 1/W of the
global batch (``ONE_ROLE``; W must divide it), the draws are those of the global batch,
and the step is the one-process step over it: K1's statistics and the BN
statistics are global and the gradients are summed over the ranks.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.models.unet2d import DualDecoder
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.state import TrainState, fold_batch_stats, make_lr_schedule
from chap_tpu_torch.train.step_chap import (StepOutput, dropout_draws,
                                            uniform_sampler)
from chap_tpu_torch.utils.spans import span


def check_rank_rows(image: torch.Tensor, cfg: Config, world: int) -> None:
    """With W > 1 ranks a one-stream step takes its 1/W of the batch."""
    if world > 1 and image.shape[0] * world != cfg.data.batch_size:
        raise ValueError(f"batch of {image.shape[0]} rows; this rank takes "
                         f"{cfg.data.batch_size // world} (batch_size "
                         f"{cfg.data.batch_size} over {world} ranks)")


def draw_supervised_uniforms(cfg: Config, image_shape: Sequence[int],
                             generator: Optional[torch.Generator] = None,
                             device: Optional[Union[str, torch.device]] = None,
                             decoders: int = 2) -> Dict[str, object]:
    """{'drop': step_chap.dropout_draws over the batch's B rows} for a model
    with ``decoders`` outputs, drawn as step_chap.uniform_sampler says."""
    b, _, *spatial = (int(s) for s in image_shape)
    rand, _ = uniform_sampler(generator, device)
    return {"drop": dropout_draws(cfg, b, spatial, rand, decoders)}


def draw_model_uniforms(model: torch.nn.Module, image_shape: Sequence[int],
                        generator: Optional[torch.Generator] = None,
                        device: Optional[Union[str, torch.device]] = None
                        ) -> Dict[str, object]:
    """{'drop': the uniforms of one train-mode pass of ``model`` over a
    batch of ``image_shape``, at its own ``dropout_shapes``}, drawn as
    step_chap.uniform_sampler says."""
    b, _, *spatial = (int(s) for s in image_shape)
    rand, _ = uniform_sampler(generator, device)
    return {"drop": [rand(s) for s in model.dropout_shapes(b, spatial)]}


def build_supervised_train_step(model: torch.nn.Module,
                                optimizer: torch.optim.Optimizer, cfg: Config,
                                device: Optional[Union[str, torch.device]] = None):
    """Returns ``step(state, batch, generator=None, draws=None) ->
    StepOutput`` for a dual-decoder model or a model of one output; batch
    and draws as in step_chap.build_chap_train_step. Metrics: {'loss'} as a
    0-d device tensor. The step raises ``ValueError`` before any update if
    another model's train-mode pass returns several outputs."""
    dual = isinstance(model, DualDecoder)
    device = resolve_device(device)
    num_classes = cfg.data.num_classes
    world = dist.world_size()
    dist.check_batch(cfg.data.batch_size, world, "supervised step")
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, the "
                         f"step on {device}")
    lr_schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                   cfg.optim.poly_power)

    def step(state: TrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, object]] = None) -> StepOutput:
        with span("chap.step"):
            return run_step(state, batch, generator, draws)

    def run_step(state, batch, generator, draws) -> StepOutput:
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("state holds another model or optimizer than "
                             "the step was built for")
        image = batch["image"]
        label = batch["label"].to(torch.int32)
        check_rank_rows(image, cfg, world)
        with span("chap.step.draws"):
            if draws is None:
                rows = image.shape[0] if world == 1 else cfg.data.batch_size
                shape = (rows,) + tuple(image.shape[1:])
                draws = (draw_supervised_uniforms(cfg, shape, generator, image.device)
                         if dual else draw_model_uniforms(model, shape, generator,
                                                          image.device))
            drop_u = [dist.shard_rows(u) for u in draws["drop"]]
        with span("chap.step.forward"):
            model.train()
            stats: Dict = {}
            out = model(image, drop_u=drop_u, stats=stats)
            if not dual and isinstance(out, tuple):
                # chap_tpu's step hands the tuple to its loss and fails
                raise ValueError(
                    f"{type(model).__name__}'s train-mode pass returns "
                    f"{len(out)} outputs; the supervised step trains the "
                    f"dual-decoder model or a model of one output")
            loss = sum(dice_ce_supervised(o, label, num_classes)
                       for o in (out if dual else (out,)))
        with span("chap.step.backward"):
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            dist.all_reduce_grads(model.parameters())
        with span("chap.step.update"):
            for group in optimizer.param_groups:
                group["lr"] = lr_schedule(state.step)
            optimizer.step()
            fold_batch_stats(model, [stats])
            state.step += 1
        return StepOutput(state, {"loss": loss.detach()})

    return step
