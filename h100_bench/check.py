"""The numbers that decide ``correct``: gaps between what the program's
timed path produced and what the plain reference computes from the same
inputs, each held to a limit of its own (limits/<cell>.json; PERF.md
gives the readings each limit was set from).

Training cells record the checked steps' losses (and the CHAP step's
labeled loss), the first gradient as SGD got it, each leaf's change over
the steps, and each BatchNorm running statistic's change after the first
step and after the last, and the CHAP step's pseudo-labels after its
largest-CC cleanup (K2). A leaf gap is |norm(program) -
norm(reference)| over the larger of the reference's norm of that leaf
and the median leaf's; a record's numbers are its worst leaf's gap and
its median leaf's. Leaves whose reference gradient is under a thousandth
of the median leaf's (a convolution's bias in front of a train-mode
BatchNorm) move by weight decay and round-off alone and are left out of
the gradient and change numbers. ``pseudo1`` is the share of step 1's
pseudo-labels that differ from those of the reference computed at the
configuration's own precision (with TF32 convolutions for float32), with
which the program agrees pixel for pixel; against float32 rounding alone
moves as many as a precision lower does (PERF.md). The eval cell compares
label maps.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

NOUGHT = 1e-3       # a leaf's gradient under this share of the median's is nought


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def moving_leaves(ref_grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought."""
    norms = _norms(ref_grad)
    median = float(np.median(list(norms.values())))
    return [k for k, v in norms.items() if v >= NOUGHT * median]


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keys: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Each leaf's gap of norms (module docstring) over ``keys``."""
    keys = list(reference) if keys is None else list(keys)
    p_norm = _norms({k: program[k] for k in keys})
    r_norm = _norms({k: reference[k] for k in keys})
    median = float(np.median(list(r_norm.values())))
    return {k: abs(p_norm[k] - r_norm[k]) / max(r_norm[k], median, 1e-30)
            for k in keys}


def loss_gap(program: List[float], reference: List[float]) -> float:
    """The worst step's |program - reference| / |reference|."""
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(program, reference))


def train_numbers(program: dict, reference: dict, worst: int = 0
                  ) -> Dict[str, object]:
    """The numbers of a training cell from two records of the checked steps
    ({'loss', 'loss_l', 'grad1', 'change', 'bn1_change', 'bn_change'}):
    the worst step's loss gap and the first step's, and for each record of
    leaves the worst leaf's gap and the median leaf's. With
    ``worst`` > 0 also the ``worst`` leaves of each, by name (calibrate.py's
    look)."""
    keep = moving_leaves(reference["grad1"])
    out: Dict[str, object] = {
        "loss": loss_gap(program["loss"], reference["loss"]),
        "loss1": loss_gap(program["loss"][:1], reference["loss"][:1]),
        "loss_l1": loss_gap(program["loss_l"][:1], reference["loss_l"][:1]),
    }
    for key, keys in (("grad1", keep), ("change", keep), ("bn1_change", None),
                      ("bn_change", None)):
        gaps = leaf_gaps(program[key], reference[key], keys)
        out[key] = max(gaps.values())
        out[key + "_median"] = float(np.median(list(gaps.values())))
        if worst:
            out[key + "_worst"] = sorted(gaps.items(), key=lambda kv: -kv[1])[:worst]
    return out


def pseudo_moved(program: dict, reference: dict) -> Dict[str, float]:
    """``pseudo1``: the share of step 1's pseudo-labels (after the CHAP
    step's largest-CC cleanup) that differ between two records; 1 where
    either has none or their shapes differ."""
    if not program.get("pseudo") or not reference.get("pseudo"):
        return {"pseudo1": 1.0}
    p, r = program["pseudo"][0].cpu().long(), reference["pseudo"][0].cpu().long()
    if p.shape != r.shape:
        return {"pseudo1": 1.0}
    return {"pseudo1": float((p != r).double().mean())}


def label_share(program: Dict[int, np.ndarray],
                reference: Dict[int, np.ndarray]) -> Dict[str, float]:
    """The eval cell's number: the worst checked volume's share of voxels
    whose labels differ from the reference's."""
    return {"labels": max(float(np.mean(program[v] != reference[v]))
                          if program[v].shape == reference[v].shape else 1.0
                          for v in reference)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(correct, {name: {'value', 'limit'}}): correct when every number is
    finite and within its limit, and no limit lacks its number."""
    shown = {k: {"value": numbers.get(k, float("nan")), "limit": v}
             for k, v in limits.items()}
    ok = all(np.isfinite(s["value"]) and s["value"] <= s["limit"]
             for s in shown.values())
    return ok, shown
