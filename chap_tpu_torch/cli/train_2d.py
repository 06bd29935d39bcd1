"""CHAP 2D training CLI (port of chap_tpu/cli/train_2d.py:21-94): the same
flag surface and snapshot layout <root>/<dataset>/<exp>_<n>_labeled/<model>/
run_N, doc.txt, config.json, log.txt + stdout; plus ``--device`` (default:
the card; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m chap_tpu_torch.cli.train_2d --exp bcp --labeled_num 7 \
        --adv_noise --dropout [--cfg configs/acdc_chap.yml] [key.path=value ...]

Data parallel over N cards (``chap`` and ``supervised``; parallel/dist.py):

    torchrun --nproc_per_node N -m chap_tpu_torch.cli.train_2d ...

(``python -m torch.distributed.run`` is the same launcher): NCCL on the
cards, gloo with ``--device cpu``. Rank 0 picks the run dir and writes its
files; the process group is destroyed at exit, also on error.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import pprint
from typing import List, Optional

import numpy as np

from chap_tpu_torch.config import load_config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.utils.launch import (dump_config, init_save_folder,
                                         setup_logging, write_doc)


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, default=None, help="YAML config overlay")
    p.add_argument("--root_path", type=str, default=None)
    p.add_argument("--dataset", type=str, default=None,
                   help="ACDC | synthetic (default from config)")
    p.add_argument("--exp", type=str, default="bcp")
    p.add_argument("--model", type=str, default="dualdecoder")
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--base_lr", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--labeled_bs", type=int, default=None)
    p.add_argument("--labeled_num", type=int, default=None)
    p.add_argument("--consistency", type=float, default=None)
    p.add_argument("--consistency_rampup", type=float, default=None)
    p.add_argument("--noise_mag", type=float, default=None)
    p.add_argument("--decoder_type", type=str, default=None,
                   choices=["same", "plus", "mcnet"])
    p.add_argument("--adv_losstype", type=str, default=None, choices=["kl", "dice"])
    p.add_argument("--adv_noise", action="store_true", default=None)
    p.add_argument("--dropout", action="store_true", default=None)
    p.add_argument("--comp_drop", action="store_true", default=None)
    p.add_argument("--topk1", type=float, default=None)
    p.add_argument("--text", type=str, default="null")
    p.add_argument("--mode", type=str, default="chap",
                   choices=["chap", "supervised", "ablation"])
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu for the plain versions)")
    p.add_argument("overrides", nargs="*", help="key.path=value config overrides")
    return p.parse_args(argv)


def build_config(args):
    cfg = load_config(args.cfg, args.overrides)
    direct = {
        "root_path": ("data", "root_path"), "dataset": ("data", "dataset"),
        "max_iterations": ("optim", "max_iterations"),
        "batch_size": ("data", "batch_size"), "base_lr": ("optim", "base_lr"),
        "seed": ("run", "seed"), "num_classes": ("data", "num_classes"),
        "labeled_bs": ("data", "labeled_bs"), "labeled_num": ("data", "labeled_num"),
        "consistency": ("semi", "consistency"),
        "consistency_rampup": ("semi", "consistency_rampup"),
        "noise_mag": ("semi", "noise_mag"), "decoder_type": ("model", "decoder_type"),
        "adv_losstype": ("semi", "adv_losstype"), "adv_noise": ("semi", "adv_noise"),
        "dropout": ("semi", "dropout"), "comp_drop": ("semi", "comp_drop"),
        "topk1": ("semi", "topk1"), "model": ("model", "name"),
        "exp": ("run", "exp"), "text": ("run", "text"),
    }
    for flag, (section, key) in direct.items():
        value = getattr(args, flag, None)
        if value is not None:
            setattr(getattr(cfg, section), key, value)
    return cfg


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the trainer's result plus the run dir, {'best_dice', 'steps',
    'save_dir'}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = build_config(args)
    with dist.process_group(cfg, device) as (rank, _, device):
        snapshot_path = os.path.join(
            cfg.run.snapshot_root, cfg.data.dataset,
            f"{cfg.run.exp}_{cfg.data.labeled_num}_labeled")
        base = os.path.join(snapshot_path, cfg.model.name)
        run = 0
        if rank == 0:
            os.makedirs(snapshot_path, exist_ok=True)
            save_dir = init_save_folder(snapshot_path, cfg.model.name,
                                        reuse_last=args.resume)
            run = int(save_dir.rsplit("_", 1)[1])
        # rank 0's run dir on every rank
        save_dir = os.path.join(base, "run_%d" % dist.broadcast_array(
            np.array([run]), device)[0])
        cfg_dict = dataclasses.asdict(cfg)
        if rank == 0:
            write_doc(save_dir, cfg.run.text)
            dump_config(save_dir, cfg_dict)
            setup_logging(save_dir)
            logging.info("%s", pprint.pformat(cfg_dict))
            logging.info("data parallel: %s, device %s", dist.describe(),
                         device)

        from chap_tpu_torch.train.trainer_2d import train
        result = train(cfg, save_dir, mode=args.mode, resume=args.resume,
                       device=device)
        logging.info("done: %s", result)
    return {**result, "save_dir": save_dir}


if __name__ == "__main__":
    main()
