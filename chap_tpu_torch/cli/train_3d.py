"""3D semi-supervised training CLI, the LA / Pancreas_CT / BraTS2019
protocols (port of chap_tpu/cli/train_3d.py): the same flags, the dataset's
patch and strides pinned from its name, and the snapshot layout
<root>/<dataset>/<exp>_<n>_labeled/<model>/run_N; plus ``--device``
(default: the card; ``cpu`` runs the kernels' plain versions).

Usage:
    python -m chap_tpu_torch.cli.train_3d --dataset LA --root_path data/LA \
        --labeled_num 8 [--cfg configs/la_chap.yml] [key.path=value ...]

Data parallel over N cards (every mode; parallel/dist.py; N must divide
``data.batch_size``, so N in {1, 2, 4} for la_chap.yml, pancreas_chap.yml and
brats_supervised.yml):

    torchrun --nproc_per_node N -m chap_tpu_torch.cli.train_3d ...

NCCL on the cards, gloo with ``--device cpu``. Rank 0 picks the run dir and
writes its files; the process group is destroyed at exit, also on error.
"""
from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional

from chap_tpu_torch.config import apply_overrides, config_to_dict, load_config
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.parallel import dist
from chap_tpu_torch.utils.launch import open_run_dir

PROTOCOLS = {
    "LA": dict(patch=(112, 112, 80), stride_xy=18, stride_z=4),
    "Pancreas_CT": dict(patch=(96, 96, 96), stride_xy=16, stride_z=16),
    "BraTS2019": dict(patch=(96, 96, 96), stride_xy=64, stride_z=64),
    "synthetic": dict(patch=(64, 64, 48), stride_xy=32, stride_z=24),
}


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--cfg", type=str, default=None,
                   help="YAML config (e.g. configs/la_chap.yml); explicit "
                        "flags still win over YAML values")
    p.add_argument("--dataset", type=str, default=None, choices=list(PROTOCOLS))
    p.add_argument("--root_path", type=str, default=None)
    p.add_argument("--exp", type=str, default=None)
    p.add_argument("--max_iterations", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--labeled_bs", type=int, default=None)
    p.add_argument("--labeled_num", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--num_classes", type=int, default=None)
    p.add_argument("--method", type=str, default=None,
                   choices=["chap", "cps", "supervised"],
                   help="chap = full method (BCP+NMS+dropout/GradSim+VAT); "
                        "cps = plain cross-pseudo-supervision baseline; "
                        "supervised = fully-supervised (BraTS protocol)")
    p.add_argument("--model", type=str, default=None,
                   help="net_factory_3d key for --method supervised")
    p.add_argument("--adv_noise", action="store_true")
    p.add_argument("--dropout", action="store_true")
    p.add_argument("--comp_drop", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--text", type=str, default="null")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu for the plain versions)")
    p.add_argument("overrides", nargs="*", help="key.path=value config overrides")
    return p.parse_args(argv)


def build_config(args):
    """(config, dataset, method): flag > YAML > Config(); the dataset pins
    patch and strides; positional overrides win over everything."""
    cfg = load_config(args.cfg)
    dataset = args.dataset or (cfg.data.dataset if cfg.data.dataset in PROTOCOLS
                               else "LA")
    for item in args.overrides:   # positional data.dataset= wins even here
        if item.startswith("data.dataset="):
            dataset = item.split("=", 1)[1]
    proto = PROTOCOLS[dataset]
    cfg.data.dataset = dataset
    cfg.data.patch_size_3d = proto["patch"]
    cfg.eval.stride_xy = proto["stride_xy"]
    cfg.eval.stride_z = proto["stride_z"]
    direct = {
        "num_classes": ("data", "num_classes"), "batch_size": ("data", "batch_size"),
        "labeled_bs": ("data", "labeled_bs"), "labeled_num": ("data", "labeled_num"),
        "root_path": ("data", "root_path"), "max_iterations": ("optim", "max_iterations"),
        "seed": ("run", "seed"), "exp": ("run", "exp"), "model": ("model", "name_3d"),
    }
    for flag, (section, key) in direct.items():
        value = getattr(args, flag)
        if value is not None:
            setattr(getattr(cfg, section), key, value)
    for flag in ("adv_noise", "dropout", "comp_drop"):
        if getattr(args, flag):
            setattr(cfg.semi, flag, True)
    apply_overrides(cfg, args.overrides)
    method = args.method or ("chap" if cfg.semi.adv_noise or cfg.semi.dropout
                             else "cps")
    return cfg, dataset, method


def main(argv: Optional[List[str]] = None) -> dict:
    """Returns the trainer's result plus the run dir, {'best_dice', 'steps',
    'save_dir'}."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg, dataset, method = build_config(args)
    with dist.process_group(cfg, device) as (_, _, device):
        snapshot_path = os.path.join(
            cfg.run.snapshot_root, dataset,
            f"{cfg.run.exp}_{cfg.data.labeled_num}_labeled")
        model_dir = (cfg.model.name_3d if method == "supervised"
                     else "dualdecoder3d")
        save_dir = open_run_dir(snapshot_path, model_dir, args.resume,
                                args.text, config_to_dict(cfg), device)

        from chap_tpu_torch.train.trainer_3d import train
        result = train(cfg, save_dir, labeled_cases=cfg.data.labeled_num,
                       mode=method, resume=args.resume, device=device)
        logging.info("done: %s", result)
    return {**result, "save_dir": save_dir}


if __name__ == "__main__":
    main()
