"""Model factories (port of chap_tpu/models/factory.py): ``net_factory``
with every 2D key and ``net_factory_3d`` with every 3D key, each with
chap_tpu's constructor arguments.

``model.dtype`` is the compute dtype, float32 or bfloat16, as chap_tpu's
``_dtype`` (factory.py:28-29) reads it, for every key of both factories:
the parameters stay float32, and every convolution, dense layer, norm and
attention computes in the compute dtype (models/layers.py says op by op
what that means; the model files say where chap_tpu's own modules compute
in float32 under bf16, and the port with them).
"""
from __future__ import annotations

import logging
from typing import Optional, Union

import torch
import torch.nn as nn

from chap_tpu_torch.config import ModelConfig
from chap_tpu_torch.device import resolve_device
from chap_tpu_torch.models.attention3d import AttentionUNet3D
from chap_tpu_torch.models.layers import compute_dtype, set_compute_dtype
from chap_tpu_torch.models.resvnet import ResVNet
from chap_tpu_torch.models.dsnet import DSNet
from chap_tpu_torch.models.efficientunet import EffiUNet
from chap_tpu_torch.models.enet import ENet
from chap_tpu_torch.models.pnet import PNet2D
from chap_tpu_torch.models.resunet2d import ResUNet2d
from chap_tpu_torch.models.swin_unet import SwinUNet
from chap_tpu_torch.models.unet2d import (DualDecoder, UNet, UNetCCT, UNetPlus,
                                          UNetURPC)
from chap_tpu_torch.models.unet3d import UNet3D
from chap_tpu_torch.models.unet3d_dv import UNet3DDvSemi
from chap_tpu_torch.models.vnet3d import DualDecoder3d, VNet, VNetDS
from chap_tpu_torch.models.voxresnet import VoxResNet

logger = logging.getLogger(__name__)

# chap_tpu's exact TPU relayouts of the VNet convolutions (ops/s2d.py)
_TPU_LAYOUT_FLAGS = ("s2d_stem", "s2d_stage2", "zpack_stage2")
_logged_flags = set()


def net_factory(net_type: str, in_chns: int, class_num: int,
                cfg: Optional[ModelConfig] = None,
                device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """2D factory, every key of chap_tpu/models/factory.py:32-66 with its
    constructor arguments: ``unet``, ``unetp``, ``dualdecoder`` / ``acalnet``
    (the ACAL trainer's shared-encoder model is the same DualDecoder),
    ``unet_cct`` and ``unet_urpc`` (``model.feature_chns``,
    ``model.dropout``), and at their fixed widths ``resunet``,
    ``dual_student``, ``swinunet`` (img_size 224), ``enet``, ``pnet`` and
    ``efficient_unet``. The model is built on ``device`` (the card unless
    ``device="cpu"``), its parameters float32, computing in
    ``model.dtype``."""
    cfg = cfg or ModelConfig()
    dtype = compute_dtype(cfg.dtype)
    dev = resolve_device(device)
    unet_kwargs = dict(feature_chns=tuple(cfg.feature_chns),
                       dropout=tuple(cfg.dropout))

    def dual():
        return DualDecoder(in_chns, class_num, cfg.decoder_type, **unet_kwargs)
    builders = {
        "unet": lambda: UNet(in_chns, class_num, **unet_kwargs),
        "unetp": lambda: UNetPlus(in_chns, class_num, **unet_kwargs),
        "dualdecoder": dual,
        "acalnet": dual,
        "unet_cct": lambda: UNetCCT(in_chns, class_num, **unet_kwargs),
        "unet_urpc": lambda: UNetURPC(in_chns, class_num, **unet_kwargs),
        "resunet": lambda: ResUNet2d(in_chns, class_num),
        "dual_student": lambda: DSNet(in_chns, class_num),
        "swinunet": lambda: SwinUNet(in_chns, class_num, img_size=224),
        "enet": lambda: ENet(in_chns, class_num),
        "pnet": lambda: PNet2D(in_chns, class_num),
        "efficient_unet": lambda: EffiUNet(in_chns, class_num),
    }
    if net_type not in builders:
        raise ValueError(f"unknown 2D net_type {net_type!r} (one of "
                         f"{', '.join(builders)})")
    return set_compute_dtype(builders[net_type](), dtype).to(dev)


def net_factory_3d(net_type: str, in_chns: int, class_num: int,
                   mode: str = "train", cfg: Optional[ModelConfig] = None,
                   device: Optional[Union[str, torch.device]] = None) -> nn.Module:
    """3D factory, every key of chap_tpu/models/factory.py:70-109 with its
    constructor arguments: ``unet_3D``, ``attention_unet`` and
    ``unet_3D_dv_semi`` (feature_scale 4), ``voxresnet`` (64 channels),
    ``vnet``, ``vnet_ds`` and ``dualdecoder`` (``model.n_filters_3d``,
    ``model.normalization_3d``, dropout in train mode only,
    net_factory_3d.py:16-27) and ``resvnet`` (16 filters, instance norm,
    dropout in train mode). Built on ``device`` (the card unless
    ``device="cpu"``), its parameters float32, computing in ``model.dtype``.
    chap_tpu's s2d / z-pack flags are accepted and change nothing (logged
    once each)."""
    cfg = cfg or ModelConfig()
    dtype = compute_dtype(cfg.dtype)
    dev = resolve_device(device)
    vnet_family = net_type in ("vnet", "vnet_ds", "dualdecoder")
    for flag in _TPU_LAYOUT_FLAGS:
        if vnet_family and getattr(cfg, flag, False) and flag not in _logged_flags:
            _logged_flags.add(flag)
            logger.info("model.%s=True: an exact TPU relayout of the VNet "
                        "convolutions in chap_tpu; it changes nothing here "
                        "(plain NCDHW convolutions)", flag)
    has_dropout = mode == "train"
    vnet_kwargs = dict(in_chns=in_chns, num_classes=class_num,
                       n_filters=cfg.n_filters_3d,
                       normalization=cfg.normalization_3d,
                       has_dropout=has_dropout)
    builders = {
        "unet_3D": lambda: UNet3D(in_chns, class_num),
        "attention_unet": lambda: AttentionUNet3D(in_chns, class_num),
        "voxresnet": lambda: VoxResNet(in_chns, class_num, feature_chns=64),
        "vnet": lambda: VNet(**vnet_kwargs),
        "vnet_ds": lambda: VNetDS(**vnet_kwargs),
        "dualdecoder": lambda: DualDecoder3d(**vnet_kwargs),
        "resvnet": lambda: ResVNet(in_chns, class_num, has_dropout=has_dropout),
        "unet_3D_dv_semi": lambda: UNet3DDvSemi(in_chns, class_num),
    }
    if net_type not in builders:
        raise ValueError(f"unknown 3D net_type {net_type!r} (one of "
                         f"{', '.join(builders)})")
    return set_compute_dtype(builders[net_type](), dtype).to(dev)
