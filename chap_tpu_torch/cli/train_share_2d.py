"""Shared-encoder ACAL training CLI (port of chap_tpu/cli/train_share_2d.py),
the reference's train_share_encoder_2D.py __main__ (:470-573) with the YAML
overlay (--cfg, :530-540): the same flags, defaults and snapshot layout
<root>/<dataset>/<exp>_<n>_labeled/acalnet/run_N, plus ``--device``
(default: the card; ``cpu`` runs the kernels' plain versions).

As in chap_tpu, ``--acal`` (store_true) and ``--consistency``,
``--consistency_rampup``, ``--decoder_type``, ``--adv_losstype`` and
``--patch_size`` have defaults that are not None, so they always override
the YAML: without ``--acal`` the run has ``semi.acal=false`` whatever the
config says (ROADMAP §3).

Usage:
    python -m chap_tpu_torch.cli.train_share_2d --cfg configs/acdc_share_acal.yml \
        --acal [--device cpu] [key.path=value ...]

Data parallel over N cards (parallel/dist.py; N must divide
``data.batch_size``, and with ``--acal`` labeled_bs and the unlabeled rows
too):

    torchrun --nproc_per_node N -m chap_tpu_torch.cli.train_share_2d ...

NCCL on the cards, gloo with ``--device cpu``. Rank 0 picks the run dir and
writes its files; the process group is destroyed at exit, also on error.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

from chap_tpu_torch.config import config_to_dict, load_config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.utils.launch import open_run_dir


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, default=None)
    p.add_argument("--root_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None)
    p.add_argument("--exp", type=str, default="danm")
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--base_lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--labeled_bs", type=int, default=None)
    p.add_argument("--labeled_num", type=int, default=3)
    p.add_argument("--consistency", type=float, default=0.1)
    p.add_argument("--consistency_rampup", type=float, default=200.0)
    p.add_argument("--consistency_type", type=str, default=None, choices=["ce", "mse"])
    p.add_argument("--acal", action="store_true")
    p.add_argument("--decoder_type", type=str, default="same",
                   choices=["same", "plus", "mcnet"])
    p.add_argument("--adv_losstype", type=str, default="mse",
                   choices=["mse", "softdice"])
    p.add_argument("--patch_size", type=int, default=64)
    p.add_argument("--text", type=str, default="null")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu for the plain versions)")
    p.add_argument("overrides", nargs="*")
    return p.parse_args(argv)


def build_config(args):
    cfg = load_config(args.cfg, args.overrides)
    for flag, (sec, key) in {
        "root_path": ("data", "root_path"), "dataset": ("data", "dataset"),
        "max_iterations": ("optim", "max_iterations"),
        "batch_size": ("data", "batch_size"), "base_lr": ("optim", "base_lr"),
        "seed": ("run", "seed"), "num_classes": ("data", "num_classes"),
        "labeled_bs": ("data", "labeled_bs"), "labeled_num": ("data", "labeled_num"),
        "consistency": ("semi", "consistency"),
        "consistency_rampup": ("semi", "consistency_rampup"),
        "consistency_type": ("semi", "consistency_type"),
        "acal": ("semi", "acal"), "decoder_type": ("model", "decoder_type"),
        "adv_losstype": ("semi", "adv_losstype"),
        "patch_size": ("semi", "mb_patch_size"),
        "exp": ("run", "exp"), "text": ("run", "text"),
    }.items():
        value = getattr(args, flag, None)
        if value is not None:
            setattr(getattr(cfg, sec), key, value)
    cfg.model.name = "acalnet"
    return cfg


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the trainer's result plus the run dir, {'best_dice_model1',
    'best_dice_model2', 'steps', 'save_dir'}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args)
    with dist.process_group(cfg, device) as (_, _, device):
        snapshot_path = os.path.join(
            cfg.run.snapshot_root, cfg.data.dataset,
            f"{cfg.run.exp}_{cfg.data.labeled_num}_labeled")
        save_dir = open_run_dir(snapshot_path, "acalnet", False, cfg.run.text,
                                config_to_dict(cfg), device)

        from chap_tpu_torch.train.trainer_share import train
        result = train(cfg, save_dir, device=device)
        logging.info("done: %s", result)
    return {**result, "save_dir": save_dir}


if __name__ == "__main__":
    main()
