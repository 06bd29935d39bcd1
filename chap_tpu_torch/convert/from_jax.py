"""Carry chap_tpu (Flax) weights into the port's torch modules.

``state_dict_from_flax`` inverts chap_tpu/convert/torch_import.py: it walks
the same rule tables (copies of torch_import.py:43-82 for the 2D
DualDecoder and :101-166 for VNet and DualDecoder3d, so the port needs
nothing of chap_tpu) and undoes the layout rules of torch_import.py:358-372:
    conv    Flax (kh, kw, I, O)                     -> torch [O, I, kh, kw]
            Flax (kx, ky, kz, I, O)                 -> torch [O, I, kx, ky, kz]
    deconv  Flax (kh, kw, I, O), spatially flipped  -> torch [I, O, kh, kw]
            Flax (kx, ky, kz, I, O), flipped on all three spatial axes
                                                    -> torch [I, O, kx, ky, kz]
    bn      scale / bias / mean / var -> weight / bias / running_mean / running_var
Inputs are numpy trees (nested dicts of arrays), e.g. jax.device_get of
``variables["params"]`` and ``variables["batch_stats"]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

Rule = Tuple[str, str, str]   # (torch key prefix, kind, Flax path)


def _convblock2d(tp: str, fp: str) -> List[Rule]:
    return [
        (f"{tp}.conv_conv.0", "conv", f"{fp}/Conv_0"),
        (f"{tp}.conv_conv.1", "bn", f"{fp}/BatchNorm_0"),
        (f"{tp}.conv_conv.4", "conv", f"{fp}/Conv_1"),
        (f"{tp}.conv_conv.5", "bn", f"{fp}/BatchNorm_1"),
    ]


def _encoder2d(tp: str = "encoder", fp: str = "encoder") -> List[Rule]:
    rules = _convblock2d(f"{tp}.in_conv", f"{fp}/in_conv")
    for i in range(1, 5):
        rules += _convblock2d(f"{tp}.down{i}.maxpool_conv.1",
                              f"{fp}/down{i}/ConvBlock_0")
    return rules


def _decoder2d(tp: str, fp: str, bilinear: bool) -> List[Rule]:
    rules: List[Rule] = []
    for i in range(1, 5):
        if bilinear:
            rules.append((f"{tp}.up{i}.conv1x1", "conv", f"{fp}/up{i}/Conv_0"))
        else:
            rules.append((f"{tp}.up{i}.up", "deconv",
                          f"{fp}/up{i}/ConvTranspose_0"))
        rules += _convblock2d(f"{tp}.up{i}.conv", f"{fp}/up{i}/ConvBlock_0")
    rules.append((f"{tp}.out_conv", "conv", f"{fp}/out_conv"))
    return rules


def dualdecoder_rules(decoder_type: str = "mcnet") -> List[Rule]:
    """DualDecoder (unet.py:245-292): decoder1 bilinear; decoder2 bilinear
    for 'same' / 'plus', transpose-conv for 'mcnet'."""
    return (_encoder2d()
            + _decoder2d("decoder1", "decoder1", bilinear=True)
            + _decoder2d("decoder2", "decoder2",
                         bilinear=(decoder_type != "mcnet")))


def _convblock3d(tp: str, fp: str, n_stages: int, has_norm: bool) -> List[Rule]:
    """vnet.py convBlock (:8-35): n_stages x (conv[,norm],relu)."""
    step = 3 if has_norm else 2
    rules: List[Rule] = []
    for i in range(n_stages):
        rules.append((f"{tp}.conv.{step * i}", "conv", f"{fp}/Conv_{i}"))
        if has_norm:
            rules.append((f"{tp}.conv.{step * i + 1}", "bn",
                          f"{fp}/BatchNorm_{i}"))
    return rules


_VNET_ENC_STAGES = (("block_one", 1), ("block_two", 2), ("block_three", 3),
                    ("block_four", 3), ("block_five", 3))
_VNET_DEC_STAGES = (("block_six", 3), ("block_seven", 3), ("block_eight", 2),
                    ("block_nine", 1))


def _vnet_encoder(tp: str, fp: str, has_norm: bool) -> List[Rule]:
    rules: List[Rule] = []
    for name, n in _VNET_ENC_STAGES:
        rules += _convblock3d(f"{tp}.{name}", f"{fp}/{name}", n, has_norm)
    for name in ("block_one_dw", "block_two_dw", "block_three_dw",
                 "block_four_dw"):
        rules.append((f"{tp}.{name}.conv.0", "conv", f"{fp}/{name}/Conv_0"))
        if has_norm:
            rules.append((f"{tp}.{name}.conv.1", "bn",
                          f"{fp}/{name}/BatchNorm_0"))
    return rules


def _vnet_decoder(tp: str, fp: str, has_norm: bool, up_type: int) -> List[Rule]:
    """vnet.py Decoder (:170-223) with Upsampling_function (:97-125): mode 0
    = ConvTranspose3d at Sequential index 0; modes 1/2 = Upsample (no
    params) at 0, Conv3d at 1; norm follows the conv."""
    rules: List[Rule] = []
    for name in ("block_five_up", "block_six_up", "block_seven_up",
                 "block_eight_up"):
        if up_type == 0:
            rules.append((f"{tp}.{name}.conv.0", "deconv",
                          f"{fp}/{name}/ConvTranspose_0"))
            norm_idx = 1
        else:
            rules.append((f"{tp}.{name}.conv.1", "conv", f"{fp}/{name}/Conv_0"))
            norm_idx = 2
        if has_norm:
            rules.append((f"{tp}.{name}.conv.{norm_idx}", "bn",
                          f"{fp}/{name}/BatchNorm_0"))
    for name, n in _VNET_DEC_STAGES:
        rules += _convblock3d(f"{tp}.{name}", f"{fp}/{name}", n, has_norm)
    rules.append((f"{tp}.out_conv", "conv", f"{fp}/out_conv"))
    return rules


def vnet_rules(normalization: str = "batchnorm") -> List[Rule]:
    has_norm = normalization != "none"
    return (_vnet_encoder("encoder", "encoder", has_norm)
            + _vnet_decoder("decoder", "decoder", has_norm, up_type=0))


def dualdecoder3d_rules(normalization: str = "batchnorm") -> List[Rule]:
    """vnet.py DualDecoder3d (:225-238): decoder1 trilinear, decoder2 deconv."""
    has_norm = normalization != "none"
    return (_vnet_encoder("encoder", "encoder", has_norm)
            + _vnet_decoder("decoder1", "decoder1", has_norm, up_type=1)
            + _vnet_decoder("decoder2", "decoder2", has_norm, up_type=0))


def _get(tree: Mapping[str, Any], path: str) -> Mapping[str, Any]:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv_weight(kernel: np.ndarray) -> np.ndarray:
    """Flax (*k, I, O) -> torch [O, I, *k]."""
    n = kernel.ndim - 2
    return np.transpose(kernel, (n + 1, n) + tuple(range(n)))


def _deconv_weight(kernel: np.ndarray) -> np.ndarray:
    """Flax (*k, I, O), flipped on every spatial axis -> torch [I, O, *k]."""
    n = kernel.ndim - 2
    flipped = kernel[(slice(None, None, -1),) * n]
    return np.transpose(flipped, (n, n + 1) + tuple(range(n)))


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         decoder_type: str = "mcnet", family: str = "dualdecoder",
                         normalization: str = "batchnorm"
                         ) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy trees) -> the port's state_dict. ``family``:
    ``dualdecoder`` or ``acalnet`` (2D, the same model, with
    ``decoder_type``), ``vnet`` or ``dualdecoder3d`` (with
    ``normalization``)."""
    if family in ("dualdecoder", "acalnet"):
        rules = dualdecoder_rules(decoder_type)
    elif family == "vnet":
        rules = vnet_rules(normalization)
    elif family == "dualdecoder3d":
        rules = dualdecoder3d_rules(normalization)
    else:
        raise ValueError(f"unknown family {family!r}")
    sd: Dict[str, torch.Tensor] = {}
    for tp, kind, fp in rules:
        leaf = _get(params, fp)
        if kind == "conv":
            sd[f"{tp}.weight"] = _t(_conv_weight(np.asarray(leaf["kernel"])))
            sd[f"{tp}.bias"] = _t(leaf["bias"])
        elif kind == "deconv":
            sd[f"{tp}.weight"] = _t(_deconv_weight(np.asarray(leaf["kernel"])))
            sd[f"{tp}.bias"] = _t(leaf["bias"])
        else:   # bn
            stats = _get(batch_stats, fp)
            sd[f"{tp}.weight"] = _t(leaf["scale"])
            sd[f"{tp}.bias"] = _t(leaf["bias"])
            sd[f"{tp}.running_mean"] = _t(stats["mean"])
            sd[f"{tp}.running_var"] = _t(stats["var"])
            sd[f"{tp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
