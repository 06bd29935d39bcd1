"""Ablation train step (port of chap_tpu/train/step_ablation.py), the
reference's train_ablation_2D.train (:92-354) and trainer_2d's ``ablation``
mode.

Plain cross-pseudo-supervision over the dual decoder, with no BCP mixing and
no largest-CC cleanup, plus the optional channel-dropout consistency pass
(``semi.dropout``) and VAT (``semi.adv_noise``) gated by the top-k
disagreement mask, and the per-step decoder disagreement ratio the reference
logs to CSV (:183-190). The dropout pass reads ``state.sim_scores`` (zeros
from create_train_state, so the score path) and never updates them, as
chap_tpu's step does. One SGD update.

Every random draw is made up front by ``draw_ablation_uniforms`` (or passed
in as ``draws``). Both VAT passes reuse one set of encoder-dropout draws, as
chap_tpu's share one key. BatchNorm running stats chain main pass ->
channel-dropout pass; the VAT passes' are discarded. K1 serves the two
supervised terms (R = 1): 2 forward + 2 backward launches a step.

With W > 1 ranks (parallel/dist.py; W must divide ``data.batch_size``, as
chap_tpu's trainer_2d.py:48-50) the batch is this rank's rows of the global
one, each half dealt on its own (``Halves``): n_l labeled rows and n_u
unlabeled ones, either possibly 0. The draws are the global batch's, sliced
to the rank's rows here (``shard_ablation_draws``), and the step is the
one-process step over the global batch: K1's and BatchNorm's statistics,
the disagreement ratio, the CPS and channel-dropout means and the VAT
divergence are global, and the gradients are summed over the ranks. The
channel-dropout pass keeps the global first half of the unlabeled rows
clean (``clean_rows``), as one process does. At bf16 compute
(``model.dtype=bfloat16``) the softmaxes, pseudo-labels and CPS terms are
taken in the logits' dtype, as chap_tpu's Flax step does.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Union

import torch

from chap_tpu_torch.config import Config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.losses.ce import cross_entropy, cross_entropy_per_pixel
from chap_tpu_torch.losses.dice import dice_ce_supervised
from chap_tpu_torch.losses.vat import vat_loss_2d
from chap_tpu_torch.models.layers import softmax
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi.patchmask import create_mask_v1
from chap_tpu_torch.train.state import TrainState, fold_batch_stats, make_lr_schedule
from chap_tpu_torch.train.step_chap import (DROPOUT_LEVELS, StepOutput,
                                            dropout_draws, uniform_sampler)
from chap_tpu_torch.train.step_share import sharpening
from chap_tpu_torch.utils.ramps import sigmoid_rampup


def draw_ablation_uniforms(cfg: Config, image_shape: Sequence[int],
                           generator: Optional[torch.Generator] = None,
                           device: Optional[Union[str, torch.device]] = None,
                           scored: bool = True) -> Dict[str, object]:
    """Every random number one ablation step consumes, drawn as
    step_chap.uniform_sampler says:

      drop     {pass: dropout_draws} for the passes main (B rows), fp (the
               channel-dropout pass) and vat (B - labeled_bs rows each)
      perturb  per-level channel-perturbation uniforms, with (``scored``) or
               without GradSim scores (models/perturb.py)
      vat_d    the initial VAT direction's uniform, shaped like the
               unlabeled half of the image
    """
    b, cin, *spatial = (int(s) for s in image_shape)
    n_u = b - cfg.data.labeled_bs
    rand, _ = uniform_sampler(generator, device)
    rows = {"main": b, "fp": n_u, "vat": n_u}
    draws: Dict[str, object] = {
        "drop": {name: dropout_draws(cfg, n, spatial, rand)
                 for name, n in rows.items()}}
    if cfg.semi.dropout:
        chns = tuple(cfg.model.feature_chns)
        shapes = perturb_draw_shapes(n_u, chns, DROPOUT_LEVELS,
                                     [scored] * len(chns), cfg.semi.comp_drop)
        draws["perturb"] = [[rand(s) for s in lvl] for lvl in shapes]
    if cfg.semi.adv_noise:
        draws["vat_d"] = rand((n_u, cin, *spatial))
    return draws


def shard_ablation_draws(draws: Dict[str, object], cfg: Config,
                         rank: Optional[int] = None,
                         world: Optional[int] = None) -> Dict[str, object]:
    """This rank's part of ``draw_ablation_uniforms``'s draws for the global
    batch: its ``Halves`` rows of the main pass, its unlabeled rows of the
    channel-dropout and VAT passes, and of the channel perturbation's the
    rows of its unlabeled rows that the pass perturbs (those past the
    global first half); 0-d draws shared. The draws themselves at W = 1."""
    world = dist.world_size() if world is None else world
    if world == 1:
        return draws
    lbs = cfg.data.labeled_bs
    unl = dist.half_rows(cfg.data.batch_size, lbs, rank, world)[1]
    clean = (cfg.data.batch_size - lbs) // 2
    lo, hi = max(unl.start, clean) - clean, max(unl.stop, clean) - clean

    def rows(u, roles):
        return dist.shard_rows(u, roles, rank, world)
    out = dict(draws)
    out["drop"] = {name: [rows(u, dist.Halves(lbs) if name == "main"
                               else dist.ONE_ROLE) for u in us]
                   for name, us in draws["drop"].items()}
    if "perturb" in draws:
        out["perturb"] = [[u if u.dim() == 0 else u[lo:hi] for u in lvl]
                          for lvl in draws["perturb"]]
    if "vat_d" in draws:
        out["vat_d"] = rows(draws["vat_d"], dist.ONE_ROLE)
    return out


def build_ablation_train_step(model: torch.nn.Module,
                              optimizer: torch.optim.Optimizer, cfg: Config,
                              device: Optional[Union[str, torch.device]] = None):
    """Returns ``step(state, batch, generator=None, draws=None) ->
    StepOutput``; batch as in step_chap.build_chap_train_step, or with W >
    1 ranks this rank's ``Halves`` rows of it (module docstring). Metrics
    {'loss', 'sup_loss', 'fp_loss', 'vat_loss', 'disagreement_ratio',
    'consistency_weight'} as 0-d device tensors."""
    device = resolve_device(device)
    num_classes = cfg.data.num_classes
    semi = cfg.semi
    world = dist.world_size()
    dist.check_batch(cfg.data.batch_size, world, "ablation step")
    # this rank's labeled and unlabeled rows (all of them at W = 1); the
    # channel-dropout pass keeps its unlabeled rows in the global first
    # half clean (at W = 1 the pass's own default, half its rows)
    lab, unl = dist.half_rows(cfg.data.batch_size, cfg.data.labeled_bs)
    lbs, clean = len(lab), None
    if world > 1:
        half = (cfg.data.batch_size - cfg.data.labeled_bs) // 2
        clean = len(range(unl.start, min(unl.stop, half)))
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
        if world > 1 and image.shape[0] != lbs + len(unl):
            raise ValueError(f"batch of {image.shape[0]} rows; this rank "
                             f"takes {lbs} labeled + {len(unl)} unlabeled "
                             f"(each half of batch_size "
                             f"{cfg.data.batch_size} over {world} ranks)")
        scores = list(state.sim_scores) if state.sim_scores else None
        if draws is None:
            rows = image.shape[0] if world == 1 else cfg.data.batch_size
            draws = draw_ablation_uniforms(cfg, (rows,) + tuple(image.shape[1:]),
                                           generator, image.device,
                                           scored=bool(scores))
        draws = shard_ablation_draws(draws, cfg)
        drop = draws["drop"]
        model.train()

        m_stats: Dict = {}
        o1, o2 = model(image, drop_u=drop["main"], stats=m_stats)
        # in the logits' dtype, argmax on it (chap_tpu's step_ablation.py:
        # 47-51)
        s1 = softmax(o1[lbs:], 1)
        s2 = softmax(o2[lbs:], 1)
        loss1 = dice_ce_supervised(o1[:lbs], label[:lbs], num_classes)
        loss2 = dice_ce_supervised(o2[:lbs], label[:lbs], num_classes)
        pseudo1 = s1.detach().argmax(dim=1).to(torch.int32)
        pseudo2 = s2.detach().argmax(dim=1).to(torch.int32)
        disagreement_ratio = dist.global_mean((pseudo1 != pseudo2).float())
        if semi.consistency_type == "ce":
            ps1 = cross_entropy_per_pixel(o1[lbs:], pseudo2)
            ps2 = cross_entropy_per_pixel(o2[lbs:], pseudo1)
        else:
            pl1 = sharpening(s1, semi.temperature).detach()
            pl2 = sharpening(s2, semi.temperature).detach()
            ps1 = ((s1 - pl2) ** 2).mean(dim=1)
            ps2 = ((s2 - pl1) ** 2).mean(dim=1)
        knowledge = (ps1 + ps2).detach()
        w = semi.consistency * sigmoid_rampup(state.step // 150,
                                              semi.consistency_rampup)

        pass_stats = [m_stats]
        zero = torch.zeros((), device=image.device)
        fp_loss = vat = zero
        if semi.dropout:
            f_stats: Dict = {}
            f1, f2 = model(image[lbs:], drop_u=drop["fp"], stats=f_stats,
                           dropout_level=DROPOUT_LEVELS, scores=scores,
                           comp_dropout=semi.comp_drop,
                           perturb_draws=draws["perturb"], clean_rows=clean)
            fp_loss = cross_entropy(f1, pseudo2) + cross_entropy(f2, pseudo1)
            pass_stats.append(f_stats)
        if semi.adv_noise:
            diff_mask = create_mask_v1(pseudo1, pseudo2, knowledge,
                                       scale_factor=4, topk=semi.topk1)

            def vat_apply(x):
                return model(x, drop_u=drop["vat"])
            vat = vat_loss_2d(vat_apply, image[lbs:], s1.detach(), s2.detach(),
                              diff_mask, d0=draws["vat_d"], xi=semi.noise_mag,
                              epi=semi.adv_epi, losstype=semi.adv_losstype)

        total = (loss1 + loss2 + w * (dist.global_mean(ps1)
                                      + dist.global_mean(ps2))
                 + w * (semi.w_adv * vat + semi.w_drop * fp_loss))
        optimizer.zero_grad(set_to_none=True)
        total.backward()
        dist.all_reduce_grads(model.parameters())
        for group in optimizer.param_groups:
            group["lr"] = lr_schedule(state.step)
        optimizer.step()
        fold_batch_stats(model, pass_stats)
        state.step += 1
        metrics = {
            "loss": total.detach(), "sup_loss": (loss1 + loss2).detach(),
            "fp_loss": fp_loss.detach(), "vat_loss": vat.detach(),
            "disagreement_ratio": disagreement_ratio,
            "consistency_weight": torch.full((), w, dtype=torch.float32,
                                             device=image.device)}
        return StepOutput(state, metrics)

    return step
