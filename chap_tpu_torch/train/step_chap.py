"""The CHAP semi-supervised train step (port of
chap_tpu/train/step_chap.py::build_chap_train_step, sequential mode).

One step: a train-mode teacher pass, largest-CC cleanup of the pseudo-labels
(K2), BCP mixing and four masked dice+CE mix losses (K1), the channel-dropout
consistency pass steered by GradSim scores, VAT gated by the top-k
disagreement mask, and one SGD update. Rank-generic, as chap_tpu's: [B, 1,
H, W] slices for the 2D DualDecoder, [B, 1, X, Y, Z] patches for the 3D
DualDecoder3d (with ``level_paths=VNET_LEVEL_PATHS``).

Every random draw of a step is made up front by ``draw_step_uniforms`` (or
passed in as ``draws``), so two steps fed the same draws compute the same
thing on any device. Both VAT passes reuse one set of encoder-dropout draws,
as chap_tpu's two VAT forwards share one key (step_chap.py:295).

BatchNorm running stats chain teacher -> student -> channel-dropout pass
(bs1 -> bs2 -> bs3, step_chap.py:273-287) with Flax's momentum; updates from
the VAT passes are discarded (models/layers.py says how the stats are kept).

chap_tpu options that change nothing here, each logged once when the step is
built:
  * ``optim.fused_passes`` (the default) runs the student, dropout and VAT
    forwards as one vmapped apply on the TPU. It is the same maths as the
    sequential passes (tests/test_step_fused.py), which the port runs.
  * ``split`` / ``optim.split_step`` compiles the step as two XLA programs
    to get around a TPU compiler's memory limit; eager PyTorch has no such
    program, so it is accepted and ignored.
``optim.remat`` maps to ``torch.utils.checkpoint`` around each model pass.
While a profiler records, the step's phases are host spans
(``chap.step.<phase>``, utils/spans.py), and so is each model pass.
"""
from __future__ import annotations

import logging
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from chap_tpu_torch.config import Config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.losses.ce import cross_entropy, cross_entropy_per_pixel
from chap_tpu_torch.losses.mix import mix_loss
from chap_tpu_torch.losses.vat import vat_loss_2d
from chap_tpu_torch.models.layers import softmax
from chap_tpu_torch.models.perturb import perturb_draw_shapes
from chap_tpu_torch.models.vnet3d import dropout_shapes as vnet_dropout_shapes
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.semi.bcp import draw_box_starts, generate_mask_nd, mix_images
from chap_tpu_torch.semi.gradsim import (ENCODER_LEVEL_PATHS, level_weights,
                                         update_grad_sim)
from chap_tpu_torch.semi.nms import largest_cc_batch
from chap_tpu_torch.semi.patchmask import create_mask_v1
from chap_tpu_torch.train.state import TrainState, fold_batch_stats, make_lr_schedule
from chap_tpu_torch.utils.ramps import sigmoid_rampup
from chap_tpu_torch.utils.spans import span

logger = logging.getLogger(__name__)

DROPOUT_LEVELS = (0, 1, 2, 3, 4)


class StepOutput(NamedTuple):
    state: TrainState
    metrics: Dict[str, torch.Tensor]


def _check_layout(cfg: Config) -> Tuple[int, int]:
    labeled_bs = cfg.data.labeled_bs
    if labeled_bs < 2 or labeled_bs % 2:
        raise ValueError(
            f"CHAP two-stream step needs an even labeled_bs >= 2 "
            f"(got labeled_bs={labeled_bs}, batch_size={cfg.data.batch_size}); "
            f"the BCP mixing splits the labeled half into a/b pairs")
    return labeled_bs, labeled_bs // 2


def uniform_sampler(generator: Optional[torch.Generator] = None,
                    device: Optional[Union[str, torch.device]] = None):
    """(rand(shape), device): ``rand`` draws uniforms from ``generator`` on
    its device and moves them to ``device`` (default: the generator's);
    without a generator it draws on ``device`` itself, from that device's
    default generator, so a step on the card draws nothing on the host."""
    if device is not None:
        device = torch.device(device)
    elif generator is not None:
        device = generator.device
    else:
        device = torch.device("cpu")
    gen_dev = generator.device if generator is not None else device

    def rand(shape):
        return torch.rand(shape, generator=generator, device=gen_dev).to(device)
    return rand, device


def level_channels(cfg: Config, rank: int) -> Tuple[int, ...]:
    """Channels of the five encoder levels that the channel perturbation and
    GradSim see: the 2D UNet's feature_chns, or the VNet's nf x (1, 2, 4, 8,
    16) for ``rank`` 3."""
    if rank == 2:
        return tuple(cfg.model.feature_chns)
    nf = cfg.model.n_filters_3d
    return tuple(nf * m for m in (1, 2, 4, 8, 16))


def dropout_draws(cfg: Config, rows: int, spatial: Sequence[int], rand,
                  decoders: int = 2) -> List[Optional[torch.Tensor]]:
    """The ``drop_u`` uniforms of one train-mode pass over ``rows`` samples.
    2D: one per encoder level, shaped like that level's first conv output
    [rows, C_i, H >> i, W >> i], or None where its dropout is 0. 3D: the
    VNet's bottleneck and each of its ``decoders`` outputs
    (models/vnet3d.py dropout_shapes)."""
    if len(spatial) == 2:
        h, w = spatial
        return [rand((rows, c, h >> i, w >> i)) if p > 0 else None
                for i, (c, p) in enumerate(zip(cfg.model.feature_chns,
                                               cfg.model.dropout))]
    return [rand(s) for s in vnet_dropout_shapes(rows, cfg.model.n_filters_3d,
                                                 spatial, decoders)]


def draw_step_uniforms(cfg: Config, image_shape: Sequence[int],
                       generator: Optional[torch.Generator] = None,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> Dict[str, object]:
    """Every random number one step consumes, drawn as ``uniform_sampler``
    says (from ``generator``, or from ``device``'s default generator):

      bcp_starts  box start per spatial axis (0-d int64)
      drop        {pass: dropout_draws} for the passes teacher, student, fp
                  (channel dropout) and vat
      perturb     per-level channel-perturbation uniforms (models/perturb.py)
      vat_d       the initial VAT direction's uniform, shaped like the
                  unlabeled half of the image
    """
    b, cin, *spatial = (int(s) for s in image_shape)
    labeled_bs, sub_bs = _check_layout(cfg)
    rand, device = uniform_sampler(generator, device)
    chns = level_channels(cfg, len(spatial))
    rows = {"teacher": b - labeled_bs, "student": 2 * sub_bs,
            "fp": b - labeled_bs, "vat": b - labeled_bs}
    draws: Dict[str, object] = {
        "bcp_starts": [s.to(device) for s in
                       draw_box_starts(spatial, generator, device=device)],
        "drop": {name: dropout_draws(cfg, n, spatial, rand)
                 for name, n in rows.items()},
    }
    if cfg.semi.dropout:
        shapes = perturb_draw_shapes(b - labeled_bs, chns, DROPOUT_LEVELS,
                                     [True] * len(chns), cfg.semi.comp_drop)
        draws["perturb"] = [[rand(s) for s in lvl] for lvl in shapes]
    if cfg.semi.adv_noise:
        draws["vat_d"] = rand((b - labeled_bs, cin, *spatial))
    return draws


# the stream of each role of the passes' rows (parallel/dist.py
# ``rank_rows``): the teacher, channel-dropout and VAT passes run on
# [uimg_a ; uimg_b], the student on the mixed [img_b/uimg_b ; uimg_a/img_a],
# and the channel perturbation draws cover the perturbed uimg_b rows
TEACHER_ROLES, STUDENT_ROLES, PERTURB_ROLES = (0, 1), (1, 0), (1,)


def shard_step_draws(draws: Dict[str, object], rank: Optional[int] = None,
                     world: Optional[int] = None) -> Dict[str, object]:
    """This rank's part of ``draw_step_uniforms``'s draws for the global
    batch (parallel/dist.py ``rank_rows``, the rows of this rank's
    pair-stream units in each pass: ``TEACHER_ROLES``, ``STUDENT_ROLES``,
    ``PERTURB_ROLES``); the BCP box and the comp-drop swap (0-d) shared. The
    draws themselves at W = 1."""
    world = dist.world_size() if world is None else world
    if world == 1:
        return draws

    def rows(u, roles):
        return dist.shard_rows(u, roles, rank, world)
    out = dict(draws)
    out["drop"] = {name: [rows(u, STUDENT_ROLES if name == "student"
                               else TEACHER_ROLES) for u in us]
                   for name, us in draws["drop"].items()}
    if "perturb" in draws:
        out["perturb"] = [[rows(u, PERTURB_ROLES) for u in lvl]
                          for lvl in draws["perturb"]]
    if "vat_d" in draws:
        out["vat_d"] = rows(draws["vat_d"], TEACHER_ROLES)
    return out


def build_chap_train_step(model: torch.nn.Module,
                          optimizer: torch.optim.Optimizer, cfg: Config,
                          use_nms: bool = True,
                          level_paths: Sequence[str] = ENCODER_LEVEL_PATHS,
                          split: bool = False,
                          device: Optional[Union[str, torch.device]] = None):
    """Returns ``step(state, batch, generator=None, draws=None) -> StepOutput``.

    batch: {'image': [B, 1, *spatial] float, 'label': [B, *spatial] int} on
    the step's device, with the two-stream layout [labeled_bs labeled ;
    B - labeled_bs unlabeled]. ``draws`` (draw_step_uniforms) replaces every
    random draw; without it the step draws from ``generator``. With W > 1
    ranks (parallel/dist.py; W must divide ``data.batch_size``) the batch is
    this rank's rows of the global one (``rank_rows`` with ``CHAP_ROLES``:
    [img_a ; img_b ; uimg_a ; uimg_b] with n_a, n_b, n_a, n_b rows, the
    rank's pair-stream units, possibly none), the draws are those of the
    global batch (this rank's rows are taken here, ``shard_step_draws``),
    and the step computes the one-process step over the global batch: BN
    statistics,
    K1's statistics, the CE and VAT means, the GradSim gradients and the
    parameter gradients are summed over the ranks. The step
    updates ``state.model`` and ``state.optimizer`` in place and returns the
    seven metrics of chap_tpu's step as 0-d device tensors (no host sync).
    ``level_paths``: the GradSim level weights, ENCODER_LEVEL_PATHS for the
    2D UNet, VNET_LEVEL_PATHS for the VNet.
    """
    device = resolve_device(device)
    num_classes = cfg.data.num_classes
    labeled_bs, sub_bs = _check_layout(cfg)
    world = dist.world_size()
    if world > 1:
        dist.check_batch(cfg.data.batch_size, world, "CHAP step")
        if cfg.data.batch_size != 2 * labeled_bs:
            raise ValueError(f"CHAP step: batch_size {cfg.data.batch_size} "
                             f"must be twice labeled_bs {labeled_bs} (its "
                             f"unlabeled half pairs the labeled one)")
    # this rank's rows of stream a and of stream b in each role (all of them
    # at W = 1)
    n_a = len(dist.stream_rows(sub_bs, 0, 2))
    n_b = len(dist.stream_rows(sub_bs, 1, 2))
    n_l = n_a + n_b
    semi = cfg.semi
    remat = cfg.optim.remat
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"model is on {next(model.parameters()).device}, the "
                         f"step on {device}")
    if cfg.optim.fused_passes and (semi.dropout or semi.adv_noise):
        logger.warning("optim.fused_passes=True: the port runs the sequential "
                       "passes, the same maths (tests/test_step_fused.py); "
                       "chap_tpu's 3D trainer forces fused_passes=False "
                       "(trainer_3d.py:189-192)")
    if split or cfg.optim.split_step:
        logger.warning("split step requested: a TPU-compiler workaround, "
                       "ignored (eager PyTorch compiles no step program)")
    lr_schedule = make_lr_schedule(cfg.optim.base_lr, cfg.optim.max_iterations,
                                   cfg.optim.poly_power)
    weights = level_weights(model, level_paths)
    every = max(1, int(semi.gradsim_every))

    def apply_model(x, drop_u, stats: bool, **kw):
        """(logits1, logits2, batch stats or None) of one train-mode pass."""
        def run(x):
            with span("chap.model.pass"):
                collected = {} if stats else None
                o1, o2 = model(x, drop_u=drop_u, stats=collected, **kw)
                return o1, o2, collected
        if remat and torch.is_grad_enabled():
            return checkpoint(run, x, use_reentrant=False)
        return run(x)

    def mix_losses(out_mix1, out_mix2, lab_a, lab_b, plab, mask_a, mask_b):
        plab_a1, plab_b1, plab_a2, plab_b2 = plab
        out_l1, out_unl1 = out_mix1[:n_b], out_mix1[n_b:]
        out_l2, out_unl2 = out_mix2[:n_b], out_mix2[n_b:]
        lu_out1, ll_in1, m1 = mix_loss(out_unl1, plab_a2, lab_a, mask_a,
                                       num_classes, u_weight=0.5, unlab=True)
        lu_out2, ll_in2, m2 = mix_loss(out_unl2, plab_a1, lab_a, mask_a,
                                       num_classes, u_weight=0.5, unlab=True)
        ll_out1, lu_in1, m3 = mix_loss(out_l1, lab_b, plab_b2, mask_b,
                                       num_classes, u_weight=0.5)
        ll_out2, lu_in2, m4 = mix_loss(out_l2, lab_b, plab_b1, mask_b,
                                       num_classes, u_weight=0.5)
        return (m1 + m2 + m3 + m4, ll_in1 + ll_in2 + ll_out1 + ll_out2,
                lu_in1 + lu_in2 + lu_out1 + lu_out2)

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
        if world > 1 and image.shape[0] != 2 * n_l:
            raise ValueError(f"batch of {image.shape[0]} rows; this rank "
                             f"takes {2 * n_l} ({n_a} + {n_b} of the "
                             f"labeled and of the unlabeled half: its "
                             f"pair-stream units of batch_size "
                             f"{cfg.data.batch_size} over {world} ranks)")
        with span("chap.step.draws"):
            if draws is None:
                rows = image.shape[0] if world == 1 else cfg.data.batch_size
                draws = draw_step_uniforms(cfg, (rows,) + tuple(image.shape[1:]),
                                           generator, image.device)
            draws = shard_step_draws(draws)
        drop = draws["drop"]
        model.train()

        # ---- teacher pass + largest-CC NMS (no gradient) -------------------
        with span("chap.step.teacher"):
            uimg_ab = image[n_l:]
            with torch.no_grad():
                pre_ab1, pre_ab2, t_stats = apply_model(uimg_ab, drop["teacher"],
                                                        True)
                # in the logits' dtype, argmax on it (bf16 near-ties go to the
                # first class, as chap_tpu's step_chap.py:120-123)
                soft1 = softmax(pre_ab1, 1)
                soft2 = softmax(pre_ab2, 1)
                pseudo1 = soft1.argmax(dim=1)
                pseudo2 = soft2.argmax(dim=1)
                knowledge = (cross_entropy_per_pixel(pre_ab1, pseudo2)
                             + cross_entropy_per_pixel(pre_ab2, pseudo1))
                pseudo_all = torch.cat([
                    pre_ab1[:n_a].argmax(1), pre_ab1[n_a:].argmax(1),
                    pre_ab2[:n_a].argmax(1), pre_ab2[n_a:].argmax(1),
                ]).to(torch.int32)
        # largest_cc_batch is looked up by name in this module at each call
        with span("chap.step.nms"), torch.no_grad():
            if use_nms:
                pseudo_all = largest_cc_batch(pseudo_all, num_classes)

        # ---- BCP mixing -----------------------------------------------------
        with span("chap.step.student"):
            plab = torch.split(pseudo_all, [n_a, n_b, n_a, n_b])
            img_a, img_b = image[:n_a], image[n_a:n_l]
            uimg_a, uimg_b = image[n_l:n_l + n_a], image[n_l + n_a:]
            lab_a, lab_b = label[:n_a], label[n_a:n_l]
            spatial = tuple(image.shape[2:])
            img_mask = generate_mask_nd(spatial, draws["bcp_starts"],
                                        device=image.device)
            mask_a, mask_b = (img_mask[None].expand(n, *spatial).float().contiguous()
                              for n in (n_a, n_b))
            net_input_unl = mix_images(uimg_a, img_a, img_mask)
            net_input_l = mix_images(img_b, uimg_b, img_mask)
            net_input_mix = torch.cat([net_input_l, net_input_unl])
            consistency_weight = semi.consistency * sigmoid_rampup(
                state.step // 150, semi.consistency_rampup)
            if semi.adv_noise:
                diff_mask = create_mask_v1(pseudo1, pseudo2, knowledge,
                                           scale_factor=4, topk=semi.topk1)

            # ---- differentiated losses (sequential passes) ------------------
            out_mix1, out_mix2, s_stats = apply_model(net_input_mix,
                                                      drop["student"], True)
            bcp_loss, loss_l, loss_u = mix_losses(out_mix1, out_mix2, lab_a,
                                                  lab_b, plab, mask_a, mask_b)
            pass_stats = [t_stats, s_stats]
        zero = torch.zeros((), device=image.device)
        fp_loss = vat = zero
        with span("chap.step.dropout"):
            if semi.dropout:
                fp1, fp2, f_stats = apply_model(
                    uimg_ab, drop["fp"], True, dropout_level=DROPOUT_LEVELS,
                    scores=list(state.sim_scores), comp_dropout=semi.comp_drop,
                    perturb_draws=draws["perturb"], clean_rows=n_a)
                fp_loss = cross_entropy(fp1, pseudo2) + cross_entropy(fp2, pseudo1)
                pass_stats.append(f_stats)
        with span("chap.step.vat"):
            if semi.adv_noise:
                def vat_apply(x):
                    o1, o2, _ = apply_model(x, drop["vat"], False)
                    return o1, o2
                vat = vat_loss_2d(vat_apply, uimg_ab, soft1, soft2, diff_mask,
                                  d0=draws["vat_d"], xi=semi.noise_mag,
                                  epi=semi.adv_epi, losstype=semi.adv_losstype)
        total = bcp_loss + consistency_weight * (
            semi.w_drop * fp_loss + semi.w_adv * vat)

        # ---- GradSim: labeled / unlabeled gradients of the level weights ----
        with span("chap.step.gradsim"):
            sim_scores = list(state.sim_scores)
            if semi.dropout and state.step % every == 0:
                grads_l = torch.autograd.grad(loss_l, weights, retain_graph=True)
                grads_u = torch.autograd.grad(loss_u, weights, retain_graph=True)
                # this rank's parts of the global batch's gradients, summed
                grads = dist.sum_tensors(grads_l + grads_u)
                grads_l, grads_u = grads[:len(weights)], grads[len(weights):]
                # decay**every keeps the reference's averaging horizon
                sim_scores = update_grad_sim(sim_scores, grads_l, grads_u,
                                             decay=0.9 ** every)

        # ---- SGD update ------------------------------------------------------
        with span("chap.step.backward"):
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            dist.all_reduce_grads(model.parameters())
        with span("chap.step.update"):
            for group in optimizer.param_groups:
                group["lr"] = lr_schedule(state.step)
            optimizer.step()

            # ---- BN running stats: bs0 -> teacher -> student [-> fp] ---------
            fold_batch_stats(model, pass_stats)

            state.step += 1
            state.sim_scores = sim_scores
        metrics = {
            "loss": total.detach(),
            "bcp_loss": bcp_loss.detach(),
            "loss_l": loss_l.detach(),
            "loss_u": loss_u.detach(),
            "fp_loss": fp_loss.detach(),
            "vat_loss": vat.detach(),
            "consistency_weight": torch.full((), consistency_weight,
                                             dtype=torch.float32,
                                             device=image.device),
        }
        return StepOutput(state, metrics)

    return step
