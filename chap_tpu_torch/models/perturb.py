"""Channel-perturbation engine (port of chap_tpu/models/perturb.py).

Every random draw can be passed in as a uniform tensor, so a test can feed
the port and chap_tpu the same numbers. JAX's ``bernoulli(key, p, shape)`` is
``uniform(key, shape) < p``; the port uses ``u < p`` with the same
convention. Per encoder level the draws come in chap_tpu's order:

    score path, comp_drop     [u_swap (scalar), u1 [B_u, C], u2 [B_u, C]]
    score path, no comp_drop  [u1 [B_u, C], u2 [B_u, C]]
    no scores, comp_drop      [u1 [B_u, C]]
    no scores, no comp_drop   [u1 [B_u, C], u2 [B_u, C]]

Features are NCHW with batch = [labeled ; unlabeled] halves
(labeled_bs = B // 2); only the unlabeled half is perturbed.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch

from chap_tpu_torch.parallel import dist

Draws = List[torch.Tensor]


def _mask_shape(feat_ndim: int, b: int, c: int) -> Tuple[int, ...]:
    """Per-(sample, channel) mask shape broadcasting over spatial dims."""
    return (b, c) + (1,) * (feat_ndim - 2)


def _channel_dropout(feat: torch.Tensor, p: float = 0.5,
                     u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """torch nn.Dropout2d: zero whole channels w.p. p, scale kept by 1/(1-p).
    ``u``: [B, C] uniforms (drawn from the global generator if None)."""
    shape = _mask_shape(feat.ndim, feat.shape[0], feat.shape[1])
    if u is None:
        u = torch.rand(shape[:2], device=feat.device)
    keep = (u < 1.0 - p).to(feat.dtype).reshape(shape)
    return feat * keep / (1.0 - p)


def _comp_binomial_masks(u: torch.Tensor, dtype: torch.dtype
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complementary {0,2} channel masks (FilterDropout.py:61-68)."""
    m1 = (u < 0.5).to(dtype) * 2.0
    return m1, 2.0 - m1


def _drop_based_on_prob(drop_probs: torch.Tensor, comp: bool, draws: Draws,
                        feat_ndim: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bernoulli keep-masks from per-(sample, channel) drop probabilities
    [B, C] with numel/sum re-scaling (FilterDropout.py:140-159)."""
    if comp:
        u_swap, u1, u2 = draws
        swap = u_swap < 0.5
        base1 = (u1 < 1.0 - drop_probs).float()
        base2 = (u2 < drop_probs).float()
        mask1 = torch.where(swap, base2, base1)
        mask2 = torch.where(swap, base1, base2)
    else:
        u1, u2 = draws
        mask1 = (u1 < 1.0 - drop_probs).float()
        mask2 = (u2 < 1.0 - drop_probs).float()
    # the rescale's count and sums run over every rank's rows (W > 1)
    numel = float(mask1.numel()) * dist.world_size()
    sum1, sum2 = dist.global_sums(mask1.sum(), mask2.sum())
    mask1 = mask1 * numel / (sum1 + 1e-8)
    mask2 = mask2 * numel / (sum2 + 1e-8)
    shape = _mask_shape(feat_ndim, mask1.shape[0], mask1.shape[1])
    return mask1.reshape(shape), mask2.reshape(shape)


def scores_dropout_v2(grad_sim: torch.Tensor, activation: torch.Tensor,
                      comp: bool, draws: Draws, kind: str = "sigmoid",
                      feat_ndim: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score-guided drop probabilities (FilterDropout.py:116-138).
    grad_sim: [C]; activation: [B, C] GAP of the unlabeled features."""
    scores = grad_sim[None, :] * activation
    mean = scores.mean(dim=1, keepdim=True)
    sigma = scores.std(dim=1, keepdim=True, correction=0)
    if kind == "gauss":
        z = (scores - mean) / (sigma * 2.0 + 1e-8)
        probs = torch.clamp(0.5 * (1 + torch.erf(z / math.sqrt(2.0))), 0.0, 1.0)
    else:  # sigmoid
        z = (scores - mean) / (sigma + 1e-8)
        probs = torch.sigmoid(-z * 2.0)
    return _drop_based_on_prob(probs, comp, draws, feat_ndim)


def _gate_mask(mask: torch.Tensor, gate) -> torch.Tensor:
    """Blend a multiplicative mask toward identity: gate=1 keeps the
    perturbation, gate=0 makes the pass clean. The gate takes the mask's
    dtype (the features'), as chap_tpu's (perturb.py:109)."""
    if gate is None:
        return mask
    g = torch.as_tensor(gate, dtype=mask.dtype, device=mask.device)
    return g * mask + (1.0 - g)


def perturb_draw_shapes(batch: int, feature_chns: Sequence[int],
                        level: Sequence[int], has_scores: Sequence[bool],
                        comp_drop: bool) -> List[List[Tuple[int, ...]]]:
    """Shapes of the uniforms perform_dropout consumes per level (see the
    module docstring); [] for a level outside ``level``."""
    b_u = batch - batch // 2
    shapes: List[List[Tuple[int, ...]]] = []
    for idx, c in enumerate(feature_chns):
        if idx not in level:
            shapes.append([])
        elif has_scores[idx]:
            shapes.append(([()] if comp_drop else []) + [(b_u, c), (b_u, c)])
        else:
            shapes.append([(b_u, c)] if comp_drop else [(b_u, c), (b_u, c)])
    return shapes


def perform_dropout(features: Sequence[torch.Tensor],
                    level: Sequence[int],
                    scores: Optional[Sequence[Optional[torch.Tensor]]] = None,
                    comp_drop: bool = False,
                    gate=None,
                    draws: Optional[Sequence[Draws]] = None,
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Two perturbed feature pyramids for the two decoders.

    features: encoder pyramid, each [B, C, H, W]. ``draws``: per-level
    uniforms (module docstring); None draws them from the global
    generator."""
    if draws is None:
        has = [scores is not None and scores[i] is not None
               for i in range(len(features))]
        shapes = perturb_draw_shapes(features[0].shape[0],
                                     [f.shape[1] for f in features], level,
                                     has, comp_drop)
        draws = [[torch.rand(s, device=features[0].device) for s in lvl]
                 for lvl in shapes]
    feature_fp1: List[torch.Tensor] = []
    feature_fp2: List[torch.Tensor] = []
    for idx, feat in enumerate(features):
        b, c = feat.shape[0], feat.shape[1]
        labeled_bs = b // 2
        lab_feat = feat[:labeled_bs]
        unlab_feat = feat[labeled_bs:]
        if idx in level:
            score_vec = None if scores is None else scores[idx]
            if score_vec is None:
                shape = _mask_shape(feat.ndim, b - labeled_bs, c)
                if comp_drop:
                    m1, m2 = _comp_binomial_masks(draws[idx][0], feat.dtype)
                    p1 = unlab_feat * _gate_mask(m1.reshape(shape), gate)
                    p2 = unlab_feat * _gate_mask(m2.reshape(shape), gate)
                else:
                    u1, u2 = draws[idx]
                    k1 = (u1 < 0.5).to(feat.dtype).reshape(shape)
                    k2 = (u2 < 0.5).to(feat.dtype).reshape(shape)
                    p1 = unlab_feat * _gate_mask(k1 / 0.5, gate)
                    p2 = unlab_feat * _gate_mask(k2 / 0.5, gate)
            else:
                activation = unlab_feat.mean(dim=tuple(range(2, feat.ndim)))
                m1, m2 = scores_dropout_v2(score_vec, activation.detach(),
                                           comp_drop, draws[idx],
                                           feat_ndim=feat.ndim)
                m1 = _gate_mask(m1.to(feat.dtype), gate)
                m2 = _gate_mask(m2.to(feat.dtype), gate)
                p1, p2 = unlab_feat * m1, unlab_feat * m2
        else:
            p1 = p2 = unlab_feat
        feature_fp1.append(torch.cat([lab_feat, p1], dim=0))
        feature_fp2.append(torch.cat([lab_feat, p2], dim=0))
    return feature_fp1, feature_fp2
