"""Model factories (port of chap_tpu/models/factory.py): ``net_factory``
with the 2D ``dualdecoder`` and ``acalnet`` keys and ``net_factory_3d`` with
``vnet`` and ``dualdecoder``; the rest of the zoo comes in later slices."""
from __future__ import annotations

import logging
from typing import Optional, Union

import torch
import torch.nn as nn

from chap_tpu_torch.config import ModelConfig
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.models.unet2d import DualDecoder
from chap_tpu_torch.models.vnet3d import DualDecoder3d, VNet

logger = logging.getLogger(__name__)

# chap_tpu's exact TPU relayouts of the VNet convolutions (ops/s2d.py)
_TPU_LAYOUT_FLAGS = ("s2d_stem", "s2d_stage2", "zpack_stage2")
_logged_flags = set()


def _check_dtype(cfg: ModelConfig) -> None:
    if cfg.dtype != "float32":
        raise ValueError(f"model.dtype {cfg.dtype!r} is not ported yet (float32 "
                         f"only; bf16 is queued in ROADMAP): pass the override "
                         f"model.dtype=float32")


def net_factory(net_type: str, in_chns: int, class_num: int,
                cfg: Optional[ModelConfig] = None,
                device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """2D factory. The model is built on ``device`` (the card unless
    ``device="cpu"``). Only float32 is ported so far."""
    cfg = cfg or ModelConfig()
    _check_dtype(cfg)
    dev = resolve_device(device)
    if net_type in ("dualdecoder", "acalnet"):
        # acalnet: the ACAL trainer's shared-encoder model, the same
        # DualDecoder (chap_tpu/models/factory.py:43-44)
        model = DualDecoder(in_chns, class_num, cfg.decoder_type,
                            tuple(cfg.feature_chns), tuple(cfg.dropout))
        return model.to(dev)
    raise ValueError(f"2D net_type {net_type!r} is not ported yet (available: "
                     f"dualdecoder, acalnet); the rest of the 2D zoo is "
                     f"ROADMAP item 18")


def net_factory_3d(net_type: str, in_chns: int, class_num: int,
                   mode: str = "train", cfg: Optional[ModelConfig] = None,
                   device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """3D factory: ``vnet`` | ``dualdecoder``, with dropout in train mode
    only (net_factory_3d.py:16-27), built on ``device`` (the card unless
    ``device="cpu"``). chap_tpu's s2d / z-pack flags are accepted and change
    nothing (logged once each)."""
    cfg = cfg or ModelConfig()
    _check_dtype(cfg)
    dev = resolve_device(device)
    for flag in _TPU_LAYOUT_FLAGS:
        if getattr(cfg, flag, False) and flag not in _logged_flags:
            _logged_flags.add(flag)
            logger.info("model.%s=True: an exact TPU relayout of the VNet "
                        "convolutions in chap_tpu; it changes nothing here "
                        "(plain NCDHW convolutions)", flag)
    kwargs = dict(in_chns=in_chns, num_classes=class_num,
                  n_filters=cfg.n_filters_3d,
                  normalization=cfg.normalization_3d,
                  has_dropout=mode == "train")
    if net_type == "vnet":
        return VNet(**kwargs).to(dev)
    if net_type == "dualdecoder":
        return DualDecoder3d(**kwargs).to(dev)
    raise ValueError(f"3D net_type {net_type!r} is not ported yet (available: "
                     f"vnet, dualdecoder); the rest of the 3D zoo is ROADMAP "
                     f"item 17")
