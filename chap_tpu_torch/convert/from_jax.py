"""Carry chap_tpu (Flax) weights into the port's torch modules.

``state_dict_from_flax`` inverts chap_tpu/convert/torch_import.py: it walks
the same rule tables (copies of torch_import.py:43-82 for the 2D
DualDecoder and :101-197 for VNet, VNetDS, DualDecoder3d and unet_3D, so
the port needs nothing of chap_tpu; for the 3D models chap_tpu has no rules
for, the tables below name the port's modules after the reference's) and
undoes the layout rules of torch_import.py:358-372:
    conv    Flax (kh, kw, I, O)                     -> torch [O, I, kh, kw]
            Flax (kx, ky, kz, I, O)                 -> torch [O, I, kx, ky, kz]
    deconv  Flax (kh, kw, I, O), spatially flipped  -> torch [I, O, kh, kw]
            Flax (kx, ky, kz, I, O), flipped on all three spatial axes
                                                    -> torch [I, O, kx, ky, kz]
    bn      scale / bias / mean / var -> weight / bias / running_mean / running_var
    gn      scale / bias                -> weight / bias (GroupNorm)
Inputs are numpy trees (nested dicts of arrays), e.g. jax.device_get of
``variables["params"]`` and ``variables["batch_stats"]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

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


def _join(tp: str, name: str, sep: str = ".") -> str:
    return f"{tp}{sep}{name}" if tp else name


def _norm_rule(tp: str, fp: str, normalization: str, i: int) -> List[Rule]:
    """The norm after a VNet conv: Flax BatchNorm_i or GroupNorm_i; the
    affine-free instancenorm and none carry nothing."""
    if normalization == "batchnorm":
        return [(tp, "bn", f"{fp}/BatchNorm_{i}")]
    if normalization == "groupnorm":
        return [(tp, "gn", f"{fp}/GroupNorm_{i}")]
    return []


def _convblock3d(tp: str, fp: str, n_stages: int, normalization: str
                 ) -> List[Rule]:
    """vnet.py convBlock (:8-35): n_stages x (conv[,norm],relu)."""
    step = 2 if normalization == "none" else 3
    rules: List[Rule] = []
    for i in range(n_stages):
        rules.append((f"{tp}.conv.{step * i}", "conv", f"{fp}/Conv_{i}"))
        rules += _norm_rule(f"{tp}.conv.{step * i + 1}", fp, normalization, i)
    return rules


_VNET_ENC_STAGES = (("block_one", 1), ("block_two", 2), ("block_three", 3),
                    ("block_four", 3), ("block_five", 3))
_VNET_DEC_STAGES = (("block_six", 3), ("block_seven", 3), ("block_eight", 2),
                    ("block_nine", 1))


def _vnet_encoder(tp: str, fp: str, normalization: str) -> List[Rule]:
    rules: List[Rule] = []
    for name, n in _VNET_ENC_STAGES:
        rules += _convblock3d(f"{tp}.{name}", f"{fp}/{name}", n, normalization)
    for name in ("block_one_dw", "block_two_dw", "block_three_dw",
                 "block_four_dw"):
        rules.append((f"{tp}.{name}.conv.0", "conv", f"{fp}/{name}/Conv_0"))
        rules += _norm_rule(f"{tp}.{name}.conv.1", f"{fp}/{name}",
                            normalization, 0)
    return rules


def _vnet_decoder(tp: str, fp: str, normalization: str, up_type: int,
                  stages=_VNET_DEC_STAGES, out_conv: str = "out_conv"
                  ) -> List[Rule]:
    """vnet.py Decoder (:170-223) with Upsampling_function (:97-125): mode 0
    = ConvTranspose3d at Sequential index 0; modes 1/2 = Upsample (no
    params) at 0, Conv3d at 1; norm follows the conv."""
    rules: List[Rule] = []
    for name in ("block_five_up", "block_six_up", "block_seven_up",
                 "block_eight_up"):
        if up_type == 0:
            rules.append((f"{_join(tp, name)}.conv.0", "deconv",
                          f"{_join(fp, name, "/")}/ConvTranspose_0"))
            norm_idx = 1
        else:
            rules.append((f"{_join(tp, name)}.conv.1", "conv",
                          f"{_join(fp, name, "/")}/Conv_0"))
            norm_idx = 2
        rules += _norm_rule(f"{_join(tp, name)}.conv.{norm_idx}",
                            _join(fp, name, "/"), normalization, 0)
    for name, n in stages:
        rules += _convblock3d(_join(tp, name), _join(fp, name, "/"), n, normalization)
    rules.append((_join(tp, out_conv), "conv", _join(fp, out_conv, "/")))
    return rules


def vnet_rules(normalization: str = "batchnorm") -> List[Rule]:
    return (_vnet_encoder("encoder", "encoder", normalization)
            + _vnet_decoder("decoder", "decoder", normalization, up_type=0))


def vnet_ds_rules(normalization: str = "batchnorm") -> List[Rule]:
    """VNetDS: VNet's encoder and deconv decoder plus the side heads
    (torch_import.py:169-180)."""
    return vnet_rules(normalization) + [
        (f"side.{n}", "conv", f"side/{n}")
        for n in ("side5", "side4", "side3", "side2")]


def dualdecoder3d_rules(normalization: str = "batchnorm") -> List[Rule]:
    """vnet.py DualDecoder3d (:225-238): decoder1 trilinear, decoder2 deconv."""
    return (_vnet_encoder("encoder", "encoder", normalization)
            + _vnet_decoder("decoder1", "decoder1", normalization, up_type=1)
            + _vnet_decoder("decoder2", "decoder2", normalization, up_type=0))


def _unet_conv3(tp: str, fp: str) -> List[Rule]:
    """UnetConv3: conv1 / conv2 Sequentials, their instance norms without
    parameters."""
    return [(f"{tp}.conv1.0", "conv", f"{fp}/Conv_0"),
            (f"{tp}.conv2.0", "conv", f"{fp}/Conv_1")]


def _unet3d_backbone() -> List[Rule]:
    rules: List[Rule] = []
    for name in ("conv1", "conv2", "conv3", "conv4", "center"):
        rules += _unet_conv3(name, name)
    for name in ("up_concat4", "up_concat3", "up_concat2", "up_concat1"):
        rules += _unet_conv3(f"{name}.conv", f"{name}/UnetConv3_0")
    return rules


def _dsv_heads() -> List[Rule]:
    return [(f"dsv{i}.dsv.0", "conv", f"dsv{i}/Conv_0") for i in (4, 3, 2)] \
        + [("dsv1", "conv", "dsv1")]


def unet3d_rules() -> List[Rule]:
    """unet_3D.py (:20-100), torch_import.py:182-197."""
    return _unet3d_backbone() + [("final", "conv", "final")]


def unet3d_dv_rules() -> List[Rule]:
    """unet_3D_dv_semi: the UNet3D backbone and the four dsv heads."""
    return _unet3d_backbone() + _dsv_heads()


def attention_unet_rules() -> List[Rule]:
    """Attention_UNet: the UNet3D backbone, the gating conv, two grid
    attention gates (theta, phi, psi, W conv + BatchNorm) and the combining
    conv + BatchNorm per attention block, the dsv heads and the fusing conv."""
    rules = _unet3d_backbone() + [("gating.conv1.0", "conv", "gating_conv")]
    for n in (2, 3, 4):
        tp = fp = f"attentionblock{n}"
        for gate in ("gate_block_1", "gate_block_2"):
            for part in ("theta", "phi", "psi"):
                rules.append((f"{tp}.{gate}.{part}", "conv", f"{fp}/{gate}/{part}"))
            rules.append((f"{tp}.{gate}.W.0", "conv", f"{fp}/{gate}/W"))
            rules.append((f"{tp}.{gate}.W.1", "bn", f"{fp}/{gate}/BatchNorm_0"))
        rules.append((f"{tp}.combine_gates.0", "conv", f"{fp}/Conv_0"))
        rules.append((f"{tp}.combine_gates.1", "bn", f"{fp}/BatchNorm_0"))
    return rules + _dsv_heads() + [("final", "conv", "final")]


def voxresnet_rules() -> List[Rule]:
    """VoxResNet: the stem, six VoxRex blocks and two up blocks (their
    bias-free convs at Sequential indices 2 and 5), the output conv."""
    rules: List[Rule] = [("conv1", "conv", "conv1")]
    for tp, fp in [(f"res{i}.block", f"res{i}") for i in range(1, 7)] + [
            (f"up{i}_conv.conv_block", f"up{i}_conv") for i in (1, 2)]:
        rules += [(f"{tp}.2", "conv", f"{fp}/Conv_0"),
                  (f"{tp}.5", "conv", f"{fp}/Conv_1")]
    return rules + [("out", "conv", "out")]


def resvnet_rules(normalization: str = "instancenorm") -> List[Rule]:
    """ResVNet: the ResNet-34 encoder (stem, BasicBlocks with their
    downsample convs) and the VNet deconv decoder with its branch head."""
    rules: List[Rule] = [("resencoder.conv1", "conv", "resencoder/conv1")]
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            tp = f"resencoder.layer{stage + 1}.{b}"
            fp = f"resencoder/layer{stage + 1}_block{b}"
            rules += [(f"{tp}.conv1", "conv", f"{fp}/Conv_0"),
                      (f"{tp}.conv2", "conv", f"{fp}/Conv_1")]
            if b == 0:
                rules.append((f"{tp}.downsample.0", "conv", f"{fp}/downsample"))
    stages = (("block_six", 3), ("block_seven", 3), ("block_eight", 2),
              ("branch_conv", 1))
    return rules + _vnet_decoder("", "", normalization, 0, stages, "branch_out")


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


FAMILIES_3D = {"vnet": vnet_rules, "vnet_ds": vnet_ds_rules,
               "dualdecoder3d": dualdecoder3d_rules, "resvnet": resvnet_rules,
               "unet_3D": unet3d_rules, "unet_3D_dv_semi": unet3d_dv_rules,
               "attention_unet": attention_unet_rules,
               "voxresnet": voxresnet_rules}
_NORMALIZED = ("vnet", "vnet_ds", "dualdecoder3d", "resvnet")


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         decoder_type: str = "mcnet", family: str = "dualdecoder",
                         normalization: Optional[str] = None
                         ) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy trees) -> the port's state_dict. ``family``:
    ``dualdecoder`` or ``acalnet`` (2D, the same model, with
    ``decoder_type``); in 3D ``vnet``, ``vnet_ds``, ``dualdecoder3d`` or
    ``resvnet`` (with ``normalization``, by default batchnorm and for resvnet
    instancenorm) and
    ``unet_3D``, ``unet_3D_dv_semi``, ``attention_unet`` or ``voxresnet``.
    ``batch_stats`` may be empty for a model without BatchNorm."""
    if family in ("dualdecoder", "acalnet"):
        rules = dualdecoder_rules(decoder_type)
    elif family in FAMILIES_3D:
        if family not in _NORMALIZED:
            rules = FAMILIES_3D[family]()
        else:   # each family's default: ResVNet's instancenorm, else batchnorm
            rules = (FAMILIES_3D[family](normalization) if normalization
                     else FAMILIES_3D[family]())
    else:
        raise ValueError(f"unknown family {family!r}")
    sd: Dict[str, torch.Tensor] = {}
    for tp, kind, fp in rules:
        leaf = _get(params, fp)
        if kind in ("conv", "deconv"):
            to_torch = _conv_weight if kind == "conv" else _deconv_weight
            sd[f"{tp}.weight"] = _t(to_torch(np.asarray(leaf["kernel"])))
            if "bias" in leaf:
                sd[f"{tp}.bias"] = _t(leaf["bias"])
        elif kind == "gn":
            sd[f"{tp}.weight"] = _t(leaf["scale"])
            sd[f"{tp}.bias"] = _t(leaf["bias"])
        else:   # bn
            stats = _get(batch_stats, fp)
            sd[f"{tp}.weight"] = _t(leaf["scale"])
            sd[f"{tp}.bias"] = _t(leaf["bias"])
            sd[f"{tp}.running_mean"] = _t(stats["mean"])
            sd[f"{tp}.running_var"] = _t(stats["var"])
            sd[f"{tp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
