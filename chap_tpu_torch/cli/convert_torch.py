"""Convert a reference PyTorch checkpoint (a ``.pth`` state dict) into a
port snapshot that cli.test_2d / cli.test_3d restore (port of
chap_tpu/cli/convert_torch.py).

The port's models carry the reference's names, so the checkpoint loads by
name (convert/from_pth.py: ``{"state_dict": ...}`` and ``module.``
unwrapped, strict). The snapshot is ``<out>/checkpoints/best/state.pt``
(utils/checkpoint.py: the weights, a fresh optimizer, step 0, and zero
GradSim scores where the 2D template carries them) and ``<out>/config.json``
(the model and data settings).

Families, chap_tpu's converter's eight (torch_import.py ``_FAMILIES``):
2D ``dualdecoder``, ``unet``, ``unetp`` and ``swinunet`` (built for 224^2,
as net_factory builds it, with ``data.image_size`` [224, 224] in the
config); 3D ``vnet``, ``vnet_ds``, ``dualdecoder3d`` (net_factory_3d's
``dualdecoder``, which the config records as ``model.name_3d``) and
``unet_3D``, at ``model.n_filters_3d`` 16. chap_tpu's own CLI fails on
three of them: it sends dualdecoder3d to a 3D factory key that does not
exist and vnet_ds to the 2D factory, and initialises swinunet on a 64^2
sample; here each is built in its factory at its size.

Usage:
    python -m chap_tpu_torch.cli.convert_torch \\
        --pth dualdecoder_best_model.pth --model dualdecoder \\
        --decoder_type mcnet --num_classes 4 --out runs/converted [--device cpu]
    python -m chap_tpu_torch.cli.test_2d --snapshot runs/converted
    python -m chap_tpu_torch.cli.convert_torch --pth vnet.pth --model vnet \\
        --num_classes 2 --out runs/converted_la
    python -m chap_tpu_torch.cli.test_3d --snapshot runs/converted_la \\
        --model vnet --dataset LA --root_path data/LA
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import List, Optional

from chap_tpu_torch.config import Config
from chap_tpu_torch.convert.from_pth import load_reference_state_dict, read_pth
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.models.factory import net_factory, net_factory_3d
from chap_tpu_torch.train.state import create_train_state, make_optimizer
from chap_tpu_torch.train.trainer_2d import TRAINABLE_KEYS
from chap_tpu_torch.utils.checkpoint import CheckpointManager

# family -> (dimension, the factory's key)
FAMILIES = {"dualdecoder": (2, "dualdecoder"), "unet": (2, "unet"),
            "unetp": (2, "unetp"), "swinunet": (2, "swinunet"),
            "vnet": (3, "vnet"), "vnet_ds": (3, "vnet_ds"),
            "dualdecoder3d": (3, "dualdecoder"), "unet_3D": (3, "unet_3D")}


def convert(pth: str, model_name: str, out: str, *, in_chns: int = 1,
            num_classes: int = 4, decoder_type: str = "mcnet",
            normalization: str = "batchnorm", device=None) -> str:
    """Write the snapshot of ``pth`` under ``out``; returns ``out``."""
    if model_name not in FAMILIES:
        raise ValueError(f"no converter for model {model_name!r}; "
                         f"available: {sorted(FAMILIES)}")
    dim, key = FAMILIES[model_name]
    device = resolve_device(device)
    cfg = Config()
    cfg.model.decoder_type = decoder_type
    cfg.model.normalization_3d = normalization
    cfg.data.in_chns, cfg.data.num_classes = in_chns, num_classes
    if dim == 3:
        cfg.model.name_3d = key
        model = net_factory_3d(key, in_chns, num_classes, mode="test",
                               cfg=cfg.model, device=device)
    else:
        cfg.model.name = key
        if key == "swinunet":
            cfg.data.image_size = (224, 224)
        model = net_factory(key, in_chns, num_classes, cfg.model, device=device)
    load_reference_state_dict(model, read_pth(pth), family=model_name)

    sim = cfg.model.feature_chns if dim == 2 and key in TRAINABLE_KEYS else ()
    state = create_train_state(model, make_optimizer(model, cfg.optim.base_lr), sim)
    os.makedirs(out, exist_ok=True)
    CheckpointManager(out).save_best(state)
    with open(os.path.join(out, "config.json"), "w") as f:
        json.dump({"model": dataclasses.asdict(cfg.model),
                   "data": {"in_chns": in_chns, "num_classes": num_classes,
                            "image_size": list(cfg.data.image_size)}}, f, indent=2)
    return out


def main(argv: Optional[List[str]] = None) -> str:
    p = argparse.ArgumentParser()
    p.add_argument("--pth", type=str, required=True)
    p.add_argument("--model", type=str, required=True, help=" | ".join(FAMILIES))
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--in_chns", type=int, default=1)
    p.add_argument("--num_classes", type=int, default=4)
    p.add_argument("--decoder_type", type=str, default="mcnet")
    p.add_argument("--normalization", type=str, default="batchnorm")
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: cuda; cpu without a card)")
    args = p.parse_args(argv)
    out = convert(args.pth, args.model, args.out, in_chns=args.in_chns,
                  num_classes=args.num_classes, decoder_type=args.decoder_type,
                  normalization=args.normalization, device=args.device)
    print(f"converted {args.pth} -> {out}/checkpoints/best")
    return out


if __name__ == "__main__":
    main()
