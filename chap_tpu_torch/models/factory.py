"""Model factory (port of chap_tpu/models/factory.py:32-47, the
``dualdecoder`` key only; the rest of the zoo comes in later slices)."""
from __future__ import annotations

from typing import Optional, Union

import torch
import torch.nn as nn

from chap_tpu_torch.config import ModelConfig
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.models.unet2d import DualDecoder


def net_factory(net_type: str, in_chns: int, class_num: int,
                cfg: Optional[ModelConfig] = None,
                device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """2D factory. The model is built on ``device`` (the card unless
    ``device="cpu"``). Only float32 is ported so far."""
    cfg = cfg or ModelConfig()
    if cfg.dtype != "float32":
        raise ValueError(f"model.dtype {cfg.dtype!r} is not ported yet "
                         f"(float32 only)")
    dev = resolve_device(device)
    if net_type == "dualdecoder":
        model = DualDecoder(in_chns, class_num, cfg.decoder_type,
                            tuple(cfg.feature_chns), tuple(cfg.dropout))
        return model.to(dev)
    raise ValueError(f"2D net_type {net_type!r} is not ported yet "
                     f"(available: dualdecoder)")
