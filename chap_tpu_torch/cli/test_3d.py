"""3D test CLI (port of chap_tpu/cli/test_3d.py), test_LA.py (:41-65) and
test_3D.py (:20-41): dataset-switched sliding-window evaluation.

Protocols (test_LA.py:23-35,50-58; test_3D.py:33-34):
    LA:          patch (112,112,80), stride_xy 18, stride_z 4,  2 classes
    Pancreas_CT: patch (96,96,96),  stride_xy 16, stride_z 16, 2 classes
    BraTS2019:   patch (96,96,96),  stride_xy 64, stride_z 64, 2 classes (unet_3D)
``--dataset synthetic`` evaluates 2 phantom volumes of 112 x 112 x 96 with
the LA protocol. Beside chap_tpu's flags: ``--ckpt best|latest`` (the
synthetic trainer writes no best slot: it has no val set) and ``--device``
(default: the card; ``cpu`` runs the kernels' plain versions). A snapshot's
config.json, when there is one, gives the model's widths (``model.*``).

Usage:
    python -m chap_tpu_torch.cli.test_3d --dataset LA --root_path data/LA \
        --snapshot <run_dir> --model dualdecoder --nms 1
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List, Optional

import numpy as np

from chap_tpu_torch.config import Config, update_values
from chap_tpu_torch.data.datasets import SyntheticVolumeDataset, Volume3dDataset
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.eval.sliding_window import test_all_case
from chap_tpu_torch.models.factory import net_factory_3d

PROTOCOLS = {
    "LA": dict(patch=(112, 112, 80), stride_xy=18, stride_z=4, model="vnet"),
    "Pancreas_CT": dict(patch=(96, 96, 96), stride_xy=16, stride_z=16, model="vnet"),
    "BraTS2019": dict(patch=(96, 96, 96), stride_xy=64, stride_z=64, model="unet_3D"),
}


class _SyntheticCases:
    """Phantom volumes [D, H, W] as [X, Y, Z] cases."""

    def __init__(self, num_classes: int):
        self.ds = SyntheticVolumeDataset((96, 112, 112), num_classes, length=2)

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        s = self.ds[i]
        return {"image": s["image"].transpose(2, 1, 0),
                "label": s["label"].transpose(2, 1, 0), "case": s["case"]}


def main(argv: Optional[List[str]] = None) -> np.ndarray:
    """Returns the per-class mean metrics [classes - 1, 4] (dice, ravd,
    hd95, asd)."""
    p = argparse.ArgumentParser()
    p.add_argument("--dataset", type=str, default="LA",
                   choices=list(PROTOCOLS) + ["synthetic"])
    p.add_argument("--root_path", type=str, default=None)
    p.add_argument("--snapshot", type=str, default=None, help="run dir with checkpoints/")
    p.add_argument("--ckpt", type=str, default="best", choices=["best", "latest"])
    p.add_argument("--model", type=str, default=None)
    p.add_argument("--num_classes", type=int, default=2)
    p.add_argument("--nms", type=int, default=0)
    p.add_argument("--sw_batch", type=int, default=8)
    p.add_argument("--detail", type=int, default=0, help="per-case metric lines")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu for the plain versions)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    proto = PROTOCOLS.get(args.dataset, PROTOCOLS["LA"])
    cfg = Config()
    cfg_path = os.path.join(args.snapshot or "", "config.json")
    if args.snapshot and os.path.exists(cfg_path):
        with open(cfg_path) as f:
            update_values({"model": json.load(f)["model"]}, cfg)
    model = net_factory_3d(args.model or proto["model"], cfg.data.in_chns,
                           args.num_classes, mode="test", cfg=cfg.model,
                           device=device)
    if args.snapshot:
        from chap_tpu_torch.train.state import create_train_state, make_optimizer
        from chap_tpu_torch.utils.checkpoint import CheckpointManager
        state = create_train_state(model, make_optimizer(model, 0.01))
        CheckpointManager(args.snapshot).restore(args.ckpt, state)

    if args.dataset == "synthetic":
        dataset = _SyntheticCases(args.num_classes)
    else:
        dataset = Volume3dDataset(args.root_path, "test.list")

    per_case = [] if args.detail else None
    metrics = test_all_case(model, dataset, args.num_classes, proto["patch"],
                            proto["stride_xy"], proto["stride_z"],
                            sw_batch=args.sw_batch, nms=bool(args.nms),
                            full_metrics=True, per_case=per_case, device=device)
    if per_case:
        for case, m in per_case:
            print(f"{case}: {m.mean(axis=0)}")
    print("per-class (dice, ravd, hd95, asd):")
    print(metrics)
    print("mean:", metrics.mean(axis=0))
    return metrics


if __name__ == "__main__":
    main()
