"""ACDC 2D test CLI (port of chap_tpu/cli/test_2d.py:27-72), the reference's
test_2D_fully.py (:97-155): restore the ``best`` or ``latest`` checkpoint of
a run dir (its config.json gives the model, any 2D net_factory key),
evaluate every case slice-wise with the chosen ensemble (over outputs 0 and
1 of a model of several outputs; a model of one takes none), print
Dice/HD95/ASD/JC per class, and append the mean to the run dir's
performance.txt. ``swinunet`` is built for 224^2, so its snapshots carry
``data.image_size`` [224, 224].

Usage:
    python -m chap_tpu_torch.cli.test_2d \
        --snapshot model/ACDC/bcp_7_labeled/dualdecoder/run_0 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.data.datasets import AcdcVolumeDataset, SyntheticVolumeDataset
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.eval.eval2d import MODEL_TYPES, make_predictor
from chap_tpu_torch.eval.eval2d import test_single_volume as eval_single_volume
from chap_tpu_torch.models.factory import net_factory
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.trainer_2d import TRAINABLE_KEYS
from chap_tpu_torch.utils.checkpoint import CheckpointManager


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Returns the per-class mean metrics [classes - 1, 4] (dice, hd95, asd,
    jc)."""
    p = argparse.ArgumentParser()
    p.add_argument("--snapshot", type=str, required=True,
                   help="run dir containing checkpoints/ and config.json")
    p.add_argument("--ckpt", type=str, default="best", choices=["best", "latest"])
    p.add_argument("--model_type", type=str, default="logit_ensemble",
                   choices=MODEL_TYPES)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu for the plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    cfg = Config()
    cfg_path = os.path.join(args.snapshot, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            update_values(json.load(f), cfg)

    model = net_factory(cfg.model.name, cfg.data.in_chns, cfg.data.num_classes,
                        cfg.model, device=device)
    # the GradSim scores of the CHAP step's dual-decoder model; restore
    # replaces them with the slot's
    sim_chns = cfg.model.feature_chns if cfg.model.name in TRAINABLE_KEYS else ()
    state = create_train_state(model, make_optimizer(model, cfg.optim.base_lr),
                               sim_chns)
    CheckpointManager(args.snapshot).restore(args.ckpt, state)

    if cfg.data.dataset.startswith("synthetic"):
        ds = SyntheticVolumeDataset((10, *cfg.data.image_size), cfg.data.num_classes,
                                    hard=cfg.data.dataset == "synthetic_hard")
    else:
        ds = AcdcVolumeDataset(cfg.data.root_path, split=args.split)

    predictor = make_predictor(model, args.model_type, device=device)
    total = None
    for i in range(len(ds)):
        sample = ds[i]
        m = np.array(eval_single_volume(sample["image"], sample["label"],
                                        predictor, cfg.data.num_classes,
                                        cfg.data.image_size, full_metrics=True))
        print(f"{sample.get('case', i)}: {m.mean(axis=0)}")
        total = m if total is None else total + m
    mean = total / len(ds)
    print("per-class (dice, hd95, asd, jc):")
    print(mean)
    print("mean:", mean.mean(axis=0))
    # appended results file, matching test_2D_fully.py:147-149
    with open(os.path.join(args.snapshot, "performance.txt"), "a") as f:
        f.write(f"{args.ckpt} {args.model_type}: {mean.mean(axis=0).tolist()}\n")
    return mean


if __name__ == "__main__":
    main()
