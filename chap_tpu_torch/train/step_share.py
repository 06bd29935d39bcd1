"""Shared-encoder adversarial (ACAL) train steps (port of
chap_tpu/train/step_share.py), the reference's train_share_encoder_2D.train
(:139-467) and train_ACAL_one_iter (:201-299).

Two decoders over one encoder learn by cross pseudo-supervision (the joint
step). On hard samples replayed from the memory bank they then play a
min-max game: the decoders MAXIMISE their mutual discrepancy while staying
supervised, with the encoder frozen (the decoder max-step), and the encoder
MINIMISES it (the encoder min-step).

The reference's split optimizers (optimizer_g = encoder, optimizer_f =
decoders, :183-184) are two ``torch.optim.SGD``s over the two parameter
groups, where chap_tpu masks one ``optax.masked`` chain per group over one
parameter tree (step_share.py:69-78). Each SGD adds the weight decay before
the momentum, as train/state.py says, and takes its LR from its OWN count at
the count before the increment; the count grows on every ``step()`` of its
optimizer, as each masked chain's schedule count does. So once replay starts
both counts grow by 2 an iteration (ROADMAP §3 records the decision to keep
it).

Every random draw (the encoder dropout) is made up front or passed in as
``draws``, as in step_supervised.py. Each pass reports its BatchNorm batch
statistics, folded into the running stats after its update with Flax's
momentum: joint -> max -> min. K1 serves ``dice_ce_supervised`` (R = 1): 2
forward + 2 backward launches in the joint step and in the max-step, none in
the min-step.

With W > 1 ranks (parallel/dist.py) each step takes this rank's rows of the
global [labeled_bs labeled ; n unlabeled or replayed] batch, each half
dealt on its own (``Halves``; a rank may hold rows of one half only), and
computes the one-process step over the global batch: the draws are the
global batch's, sliced here; K1's and BatchNorm's statistics, the CPS
means and the discrepancy's sums are global; and each backward is followed
by one all-reduce of the gradients of the group its optimizer updates
(both in the joint step, the decoders' in the max-step, the encoder's in
the min-step). The two schedule counts stay replicated. W must divide
``data.batch_size`` (chap_tpu's mesh rule; the trainer adds the replay's).
At bf16 compute (``model.dtype=bfloat16``) the softmaxes, the CPS terms,
the knowledge map and the discrepancy's per-pixel terms are in the logits'
dtype, as in chap_tpu's Flax steps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import torch
import torch.nn as nn

from chap_tpu_torch.config import Config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.losses.ce import cross_entropy_per_pixel, mse_loss_noreduction
from chap_tpu_torch.losses.dice import dice_ce_supervised, soft_dice_loss_masked
from chap_tpu_torch.models.layers import softmax
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.train.state import fold_batch_stats, make_lr_schedule
from chap_tpu_torch.train.step_supervised import draw_supervised_uniforms
from chap_tpu_torch.utils.ramps import sigmoid_rampup

Metrics = Dict[str, torch.Tensor]


@dataclass
class ShareTrainState:
    step: int
    model: nn.Module
    optimizer_g: torch.optim.Optimizer     # encoder
    optimizer_f: torch.optim.Optimizer     # decoders
    count_g: int = 0                       # optimizer_g's schedule count
    count_f: int = 0                       # optimizer_f's schedule count


def encoder_parameters(model: nn.Module) -> List[nn.Parameter]:
    return list(model.encoder.parameters())


def decoder_parameters(model: nn.Module) -> List[nn.Parameter]:
    return [p for name, p in model.named_parameters()
            if not name.startswith("encoder.")]


def sharpening(p: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """Temperature sharpening p^T / (p^T + (1-p)^T), T = 1 / temperature
    (train_ours_2D.py:60-64)."""
    t = 1.0 / temperature
    pt = p ** t
    return pt / (pt + (1.0 - p) ** t)


def make_group_optimizers(model: nn.Module, cfg: Config
                          ) -> Tuple[torch.optim.SGD, torch.optim.SGD]:
    """(optimizer_g over the encoder, optimizer_f over both decoders)."""
    def sgd(params):
        return torch.optim.SGD(params, lr=cfg.optim.base_lr,
                               momentum=cfg.optim.momentum,
                               weight_decay=cfg.optim.weight_decay)
    return sgd(encoder_parameters(model)), sgd(decoder_parameters(model))


def create_share_state(model: nn.Module, cfg: Config) -> ShareTrainState:
    opt_g, opt_f = make_group_optimizers(model, cfg)
    return ShareTrainState(step=0, model=model, optimizer_g=opt_g,
                           optimizer_f=opt_f)


def _sgd_update(optimizer: torch.optim.Optimizer, count: int, schedule) -> int:
    """One SGD update at the LR of ``count``; returns the next count."""
    for group in optimizer.param_groups:
        group["lr"] = schedule(count)
    optimizer.step()
    return count + 1


def _discrepancy(s1: torch.Tensor, s2: torch.Tensor, mask: torch.Tensor,
                 losstype: str) -> torch.Tensor:
    """Mutual decoder discrepancy of the softmaxes [n, C, H, W] on the
    replayed half, restricted to the replay patch mask [n, H, W]
    (train_share_encoder_2D.py:242-256)."""
    if losstype == "mse":
        d1 = mse_loss_noreduction(s1, s2.detach())
        d2 = mse_loss_noreduction(s2, s1.detach())
        m = mask.unsqueeze(1)
        sum1, sum2, m_sum = dist.global_sums((d1 * m).sum(), (d2 * m).sum(),
                                             mask.sum())
        return (sum1 + sum2) / (m_sum + 1e-16)
    if losstype == "softdice":
        inv = 1.0 - mask    # the reference's ~mask.bool() (:253-254)
        return (soft_dice_loss_masked(s1, s2.detach(), inv)
                + soft_dice_loss_masked(s2, s1.detach(), inv))
    raise ValueError(losstype)


class _Checks:
    """What every ACAL step checks before it runs; ``labeled`` is this
    rank's labeled rows (``Halves``; all of them at W = 1)."""

    def __init__(self, model, opt_g, opt_f, device, cfg: Config):
        self.model, self.opt_g, self.opt_f = model, opt_g, opt_f
        if next(model.parameters()).device.type != device.type:
            raise ValueError(f"model is on {next(model.parameters()).device}, "
                             f"the step on {device}")
        self.world = dist.world_size()
        dist.check_batch(cfg.data.batch_size, self.world, "ACAL step")
        self.lbs = cfg.data.labeled_bs
        self.labeled = len(dist.half_rows(cfg.data.batch_size, self.lbs)[0])

    def __call__(self, state: ShareTrainState) -> None:
        if (state.model is not self.model or state.optimizer_g is not self.opt_g
                or state.optimizer_f is not self.opt_f):
            raise ValueError("state holds another model or optimizers than "
                             "the step was built for")

    def drop(self, cfg: Config, image: torch.Tensor, rows: int, generator,
             draws) -> list:
        """This rank's encoder-dropout draws of a global batch of ``rows``
        rows (``draws``, or drawn from ``generator`` at the global shape)."""
        if draws is None:
            draws = draw_supervised_uniforms(
                cfg, (rows,) + tuple(image.shape[1:]), generator, image.device)
        return [dist.shard_rows(u, dist.Halves(self.lbs)) for u in draws["drop"]]


def build_share_joint_step(model: nn.Module, opt_g: torch.optim.Optimizer,
                           opt_f: torch.optim.Optimizer, cfg: Config,
                           device: Optional[Union[str, torch.device]] = None):
    """Returns ``step(state, batch, generator=None, draws=None) -> (state,
    metrics, knowledge)``: the joint CPS step (train_share_encoder_2D.py:
    307-356). batch and draws as in step_supervised.py (with W > 1 ranks
    this rank's ``Halves`` rows, the draws the global batch's). Metrics
    {'loss', 'model1_loss', 'model2_loss'} are 0-d device tensors;
    ``knowledge`` is the detached per-pixel map ps1 + ps2 [B - labeled_bs,
    H, W] (this rank's unlabeled rows) that feeds the memory bank
    (:343-344). Both optimizers step."""
    checks = _Checks(model, opt_g, opt_f, resolve_device(device), cfg)
    num_classes = cfg.data.num_classes
    lbs = checks.labeled
    semi = cfg.semi
    schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                cfg.optim.poly_power)

    def step(state: ShareTrainState, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, object]] = None
             ) -> Tuple[ShareTrainState, Metrics, torch.Tensor]:
        checks(state)
        image = batch["image"]
        label = batch["label"].to(torch.int32)
        rows = cfg.data.batch_size if checks.world > 1 else image.shape[0]
        drop = checks.drop(cfg, image, rows, generator, draws)
        model.train()
        stats: Dict = {}
        o1, o2 = model(image, drop_u=drop, stats=stats)
        s1 = softmax(o1[lbs:], 1)
        s2 = softmax(o2[lbs:], 1)
        loss1 = dice_ce_supervised(o1[:lbs], label[:lbs], num_classes)
        loss2 = dice_ce_supervised(o2[:lbs], label[:lbs], num_classes)
        if semi.consistency_type == "ce":
            pseudo1 = s1.detach().argmax(dim=1)
            pseudo2 = s2.detach().argmax(dim=1)
            ps1 = cross_entropy_per_pixel(o1[lbs:], pseudo2)
            ps2 = cross_entropy_per_pixel(o2[lbs:], pseudo1)
        else:   # mse against sharpened soft targets
            pl1 = sharpening(s1, semi.temperature).detach()
            pl2 = sharpening(s2, semi.temperature).detach()
            ps1 = ((s1 - pl2) ** 2).mean(dim=1)
            ps2 = ((s2 - pl1) ** 2).mean(dim=1)
        w = semi.consistency * sigmoid_rampup(state.step // 150,
                                              semi.consistency_rampup)
        model1_loss = loss1 + w * dist.global_mean(ps1)
        model2_loss = loss2 + w * dist.global_mean(ps2)
        loss = model1_loss + model2_loss
        model.zero_grad(set_to_none=True)
        loss.backward()
        dist.all_reduce_grads(model.parameters())
        state.count_f = _sgd_update(opt_f, state.count_f, schedule)
        state.count_g = _sgd_update(opt_g, state.count_g, schedule)
        fold_batch_stats(model, [stats])
        state.step += 1
        metrics = {"loss": loss.detach(), "model1_loss": model1_loss.detach(),
                   "model2_loss": model2_loss.detach()}
        return state, metrics, (ps1 + ps2).detach()

    return step


def build_acal_steps(model: nn.Module, opt_g: torch.optim.Optimizer,
                     opt_f: torch.optim.Optimizer, cfg: Config,
                     device: Optional[Union[str, torch.device]] = None):
    """(decoder_max_step, encoder_min_step) of the replay min-max game.

    decoder_max_step(state, image, label, mask, generator=None, draws=None,
    rows=None) and encoder_min_step(state, image, mask, generator=None,
    draws=None, rows=None) each return (state, metrics). ``image`` is
    [labeled_bs labeled ; n replayed] on the step's device, ``label`` covers
    at least the labeled rows and ``mask`` is the replay patch mask [n, H,
    W]; with W > 1 ranks this rank's ``Halves`` rows of each (n may be any
    count), the draws the global batch's, and ``rows`` the global batch's
    row count (labeled_bs plus the replayed rows), which the dropout draws
    need when they are drawn here. Neither advances ``state.step``."""
    checks = _Checks(model, opt_g, opt_f, resolve_device(device), cfg)
    num_classes = cfg.data.num_classes
    lbs = checks.labeled
    semi = cfg.semi
    schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                cfg.optim.poly_power)
    enc_params = encoder_parameters(model)
    dec_params = decoder_parameters(model)

    def forward(image, generator, draws, rows, **kw):
        if rows is None:
            if checks.world > 1 and draws is None:
                raise ValueError("with W > 1 ranks the replay steps draw their "
                                 "dropout at the global batch: pass its rows")
            rows = image.shape[0]
        drop = checks.drop(cfg, image, rows, generator, draws)
        model.train()
        stats: Dict = {}
        o1, o2 = model(image, drop_u=drop, stats=stats, **kw)
        return o1, o2, stats

    def decoder_max_step(state: ShareTrainState, image: torch.Tensor,
                         label: torch.Tensor, mask: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, object]] = None,
                         rows: Optional[int] = None
                         ) -> Tuple[ShareTrainState, Metrics]:
        """Decoders maximise the discrepancy while staying supervised, loss
        = sup - dis (:257), with the encoder's features detached; only
        optimizer_f steps."""
        checks(state)
        label = label[:lbs].to(torch.int32)
        o1, o2, stats = forward(image, generator, draws, rows,
                                stop_encoder_grad=True)
        lab1 = dice_ce_supervised(o1[:lbs], label, num_classes)
        lab2 = dice_ce_supervised(o2[:lbs], label, num_classes)
        dis = _discrepancy(softmax(o1[lbs:], 1), softmax(o2[lbs:], 1), mask,
                           semi.adv_losstype)
        loss = (lab1 + lab2) - dis
        model.zero_grad(set_to_none=True)
        loss.backward()
        dist.all_reduce_grads(dec_params)
        state.count_f = _sgd_update(opt_f, state.count_f, schedule)
        fold_batch_stats(model, [stats])
        return state, {"dis_loss": dis.detach(), "acal_f_loss": loss.detach()}

    def encoder_min_step(state: ShareTrainState, image: torch.Tensor,
                         mask: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Dict[str, object]] = None,
                         rows: Optional[int] = None
                         ) -> Tuple[ShareTrainState, Metrics]:
        """The encoder minimises the same discrepancy (:266-299); the
        backward reaches the encoder's parameters only, and only
        optimizer_g steps."""
        checks(state)
        o1, o2, stats = forward(image, generator, draws, rows)
        dis = _discrepancy(softmax(o1[lbs:], 1), softmax(o2[lbs:], 1), mask,
                           semi.adv_losstype)
        model.zero_grad(set_to_none=True)
        dis.backward(inputs=enc_params)
        dist.all_reduce_grads(enc_params)
        state.count_g = _sgd_update(opt_g, state.count_g, schedule)
        fold_batch_stats(model, [stats])
        return state, {"dis_loss_g": dis.detach()}

    return decoder_max_step, encoder_min_step
