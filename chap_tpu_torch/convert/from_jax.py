"""Carry chap_tpu (Flax) weights into the port's torch modules.

``state_dict_from_flax`` inverts chap_tpu/convert/torch_import.py: it walks
the same rule tables (copies of torch_import.py:43-100 for the 2D
DualDecoder, UNet and UNetPlus, :101-197 for VNet, VNetDS, DualDecoder3d
and unet_3D, :214-299 for SwinUNet and the EfficientNet-b0 encoder, so the
port needs nothing of chap_tpu; for the models chap_tpu has no rules for,
the tables below name the port's modules after the reference's) and
undoes the layout rules of torch_import.py:358-372:
    conv    Flax (kh, kw, I, O)                     -> torch [O, I, kh, kw]
            Flax (kx, ky, kz, I, O)                 -> torch [O, I, kx, ky, kz]
    deconv  Flax (kh, kw, I, O), spatially flipped  -> torch [I, O, kh, kw]
            Flax (kx, ky, kz, I, O), flipped on all three spatial axes
                                                    -> torch [I, O, kx, ky, kz]
    linear  Flax Dense (I, O)                       -> torch [O, I]
    bn      scale / bias / mean / var -> weight / bias / running_mean / running_var
    gn, ln  scale / bias                -> weight / bias (GroupNorm, LayerNorm)
    prelu   negative_slope ()           -> weight [1]
    raw     a parameter as it is (Swin's relative position bias table, DSNet's
            proxies, the decoders' queries)
    stack   one row a parameter ("|"-joined paths): per-level embeddings
    mha     MultiHeadDotProductAttention's query / key / value (I, H, hd)
            and out (H, hd, O) -> nn.MultiheadAttention's packed
            in_proj_weight [3 D, D], in_proj_bias and out_proj
Inputs are numpy trees (nested dicts of arrays), e.g. jax.device_get of
``variables["params"]`` and ``variables["batch_stats"]``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

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


def unet2d_rules(tp: str = "", fp: str = "") -> List[Rule]:
    """UNet (unet.py:498-552): encoder + the bilinear decoder, torch
    ``decoder1`` (torch_import.py:85-87); under ``tp`` / ``fp`` (DSNet's
    students)."""
    return (_encoder2d(_join(tp, "encoder"), _join(fp, "encoder", "/"))
            + _decoder2d(_join(tp, "decoder1"), _join(fp, "decoder", "/"),
                         bilinear=True))


def unetp_rules() -> List[Rule]:
    """UNet_plus (unet.py:554-620): the compact module's auto names
    Encoder_0 / DecoderPlus_0 (torch_import.py:90-100)."""
    return (_encoder2d("encoder", "Encoder_0")
            + _decoder2d("decoder", "DecoderPlus_0", bilinear=True))


def unet_cct_rules() -> List[Rule]:
    """UNet_CCT (unet.py:776-801): the main decoder and three aux decoders."""
    rules = _encoder2d()
    for name in ("main_decoder", "aux_decoder1", "aux_decoder2", "aux_decoder3"):
        rules += _decoder2d(name, name, bilinear=True)
    return rules


def unet_urpc_rules() -> List[Rule]:
    """UNet_URPC (unet.py:404-464): chap_tpu's compact up1..up4 and four
    heads; the port's Decoder_URPC names."""
    rules = _encoder2d("encoder", "Encoder_0")
    for i in range(1, 5):
        rules.append((f"decoder.up{i}.conv1x1", "conv", f"up{i}/Conv_0"))
        rules += _convblock2d(f"decoder.up{i}.conv", f"up{i}/ConvBlock_0")
    rules.append(("decoder.out_conv", "conv", "out_conv"))
    return rules + [(f"decoder.out_conv_dp{i}", "conv", f"out_dp{i}")
                    for i in (3, 2, 1)]


def resunet_rules() -> List[Rule]:
    """ResUNet2d: the ResNet-34 stem and BasicBlocks, the UNet decoder."""
    rules: List[Rule] = [("encoder.conv1", "conv", "encoder/conv1"),
                         ("encoder.bn1", "bn", "encoder/bn1")]
    for stage, blocks in enumerate((3, 4, 6, 3)):
        for b in range(blocks):
            tp = f"encoder.layer{stage + 1}.{b}"
            fp = f"encoder/layer{stage + 1}_block{b}"
            rules += [(f"{tp}.conv1", "conv", f"{fp}/Conv_0"),
                      (f"{tp}.bn1", "bn", f"{fp}/BatchNorm_0"),
                      (f"{tp}.conv2", "conv", f"{fp}/Conv_1"),
                      (f"{tp}.bn2", "bn", f"{fp}/BatchNorm_1")]
            if b == 0:
                rules += [(f"{tp}.downsample.0", "conv", f"{fp}/downsample"),
                          (f"{tp}.downsample.1", "bn", f"{fp}/downsample_bn")]
    return rules + _decoder2d("decoder", "decoder", bilinear=True)


def dsnet_rules() -> List[Rule]:
    """DSNet: two UNet students, the proxies, two projector heads, two
    cross-attention modules and the CLUB estimator."""
    rules = unet2d_rules("student1", "student1") + unet2d_rules("student2",
                                                                 "student2")
    rules += [(n, "raw", n) for n in ("shared_proxy", "independent_proxy1",
                                      "independent_proxy2")]
    for i in (1, 2):
        rules += [(f"projector{i}.conv1", "conv", f"projector{i}/Conv_0"),
                  (f"projector{i}.bn", "bn", f"projector{i}/BatchNorm_0"),
                  (f"projector{i}.conv2", "conv", f"projector{i}/Conv_1")]
        rules += [(f"att{i}.{n}", "linear", f"att{i}/{n}")
                  for n in ("q_fc", "k_fc", "v_fc", "proj")]
        rules += [(f"att{i}.ffn.fc1", "linear", f"att{i}/FFN_0/Dense_0"),
                  (f"att{i}.ffn.fc2", "linear", f"att{i}/FFN_0/Dense_1"),
                  (f"att{i}.norm", "ln", f"att{i}/LayerNorm_0")]
    return rules + [("club.fc1", "linear", "club/fc1"),
                    ("club.fc2", "linear", "club/fc2")]


def _swin_block_rules(tp: str, fp: str) -> List[Rule]:
    """SwinTransformerBlock -> chap SwinBlock (torch_import.py:199-211)."""
    return [
        (f"{tp}.norm1", "ln", f"{fp}/LayerNorm_0"),
        (f"{tp}.attn.qkv", "linear", f"{fp}/WindowAttention_0/qkv"),
        (f"{tp}.attn.proj", "linear", f"{fp}/WindowAttention_0/proj"),
        (f"{tp}.attn.relative_position_bias_table", "raw",
         f"{fp}/WindowAttention_0/relative_position_bias_table"),
        (f"{tp}.norm2", "ln", f"{fp}/LayerNorm_1"),
        (f"{tp}.mlp.fc1", "linear", f"{fp}/Mlp_0/Dense_0"),
        (f"{tp}.mlp.fc2", "linear", f"{fp}/Mlp_0/Dense_1"),
    ]


def swinunet_rules(depths: Sequence[int] = (2, 2, 2, 2)) -> List[Rule]:
    """SwinTransformerSys -> chap SwinUNet (torch_import.py:214-263)."""
    n = len(depths)
    rules: List[Rule] = [
        ("patch_embed.proj", "conv", "patch_embed"),
        ("patch_embed.norm", "ln", "LayerNorm_0"),
        ("norm", "ln", "norm"),
        ("norm_up", "ln", "norm_up"),
        ("up.expand", "linear", "up_x4/Dense_0"),
        ("up.norm", "ln", "up_x4/LayerNorm_0"),
        ("output", "conv", "output"),
    ]
    for i in range(n):
        for d in range(depths[i]):
            rules += _swin_block_rules(f"layers.{i}.blocks.{d}", f"enc{i}_blk{d}")
        if i < n - 1:
            rules.append((f"layers.{i}.downsample.norm", "ln",
                          f"merge{i}/LayerNorm_0"))
            rules.append((f"layers.{i}.downsample.reduction", "linear",
                          f"merge{i}/Dense_0"))
    rules.append(("layers_up.0.expand", "linear", "expand0/Dense_0"))
    rules.append(("layers_up.0.norm", "ln", "expand0/LayerNorm_0"))
    for j in range(1, n):
        for d in range(depths[n - 1 - j]):
            rules += _swin_block_rules(f"layers_up.{j}.blocks.{d}",
                                       f"dec{j - 1}_blk{d}")
        rules.append((f"concat_back_dim.{j}", "linear", f"skip_reduce{j - 1}"))
        if j < n - 1:
            rules.append((f"layers_up.{j}.upsample.expand", "linear",
                          f"expand{j}/Dense_0"))
            rules.append((f"layers_up.{j}.upsample.norm", "ln",
                          f"expand{j}/LayerNorm_0"))
    return rules


def _swin_depths(params: Mapping[str, Any]) -> Tuple[int, ...]:
    """A chap SwinUNet tree's encoder depths, from its block names."""
    depths = []
    while any(k.startswith(f"enc{len(depths)}_blk") for k in params):
        depths.append(sum(k.startswith(f"enc{len(depths)}_blk") for k in params))
    return tuple(depths)


def swin_decoder_rules(params: Mapping[str, Any]) -> List[Rule]:
    """chap SwinDecoder (swin_unet.py:194-279) -> the port's SwinDecoder:
    the level count and each stage's depth read off the tree (stage inx's
    blocks ``up{inx}_blk{d}``), the projector head where the tree holds it
    (Flax makes it only when a call asks for the features)."""
    n = _count(params, "patch_proj")
    rules: List[Rule] = []
    for i in range(n):
        rules += [(f"patch_embed.{i}.proj", "conv", f"patch_proj{i}"),
                  (f"patch_embed.{i}.norm", "ln", f"patch_norm{i}")]
    rules += [("layers_up.0.expand", "linear", "expand0/Dense_0"),
              ("layers_up.0.norm", "ln", "expand0/LayerNorm_0")]
    for inx in range(1, n):
        d = 0
        while f"up{inx}_blk{d}" in params:
            rules += _swin_block_rules(f"layers_up.{inx}.blocks.{d}", f"up{inx}_blk{d}")
            d += 1
        rules.append((f"concat_back_dim.{inx}", "linear", f"concat_back{inx}"))
        if inx < n - 1:
            rules += [(f"layers_up.{inx}.upsample.expand", "linear",
                       f"expand{inx}/Dense_0"),
                      (f"layers_up.{inx}.upsample.norm", "ln",
                       f"expand{inx}/LayerNorm_0")]
    rules += [("norm_up", "ln", "norm_up"), ("up.expand", "linear", "final_expand"),
              ("up.norm", "ln", "final_norm"), ("output", "conv", "output")]
    if "proj1" in params:
        rules += [("proj1", "conv", "proj1"), ("proj_bn", "bn", "proj_bn"),
                  ("proj2", "conv", "proj2")]
    return rules


def enet_rules() -> List[Rule]:
    """ENet: the initial block and the bottlenecks under chap_tpu's names."""
    def bn_prelu(tp, fp, i):
        return [(f"{tp}.bn{i + 1}", "bn", f"{fp}/BatchNorm_{i}"),
                (f"{tp}.prelu{i + 1}", "prelu", f"{fp}/PReLU_{i}")]

    rules: List[Rule] = [("initial.conv", "conv", "initial/Conv_0"),
                         ("initial.bn", "bn", "initial/BatchNorm_0"),
                         ("initial.prelu", "prelu", "initial/PReLU_0")]
    blocks = ([("down1_0", "down1_0", "down")]
              + [(f"stage1.reg1_{i}", f"reg1_{i}", "reg") for i in range(1, 5)]
              + [("down2_0", "down2_0", "down")]
              + [(f"stage23.{n}", n, "asym" if n.startswith("asym") else "reg")
                 for stage in (2, 3) for n in (
                     f"reg{stage}_1", f"dil{stage}_2", f"asym{stage}_3",
                     f"dil{stage}_4", f"reg{stage}_5", f"dil{stage}_6",
                     f"asym{stage}_7", f"dil{stage}_8")]
              + [("up4_0", "up4_0", "up"), ("reg4_1", "reg4_1", "reg"),
                 ("reg4_2", "reg4_2", "reg"), ("up5_0", "up5_0", "up"),
                 ("reg5_1", "reg5_1", "reg")])
    for tp, fp, kind in blocks:
        if kind == "up":
            # the main branch's conv and BN come first in chap_tpu's names
            rules += [(f"{tp}.main_conv", "conv", f"{fp}/Conv_0"),
                      (f"{tp}.main_bn", "bn", f"{fp}/BatchNorm_0"),
                      (f"{tp}.conv1", "conv", f"{fp}/Conv_1"),
                      (f"{tp}.bn1", "bn", f"{fp}/BatchNorm_1"),
                      (f"{tp}.prelu1", "prelu", f"{fp}/PReLU_0"),
                      (f"{tp}.deconv", "deconv", f"{fp}/ConvTranspose_0"),
                      (f"{tp}.bn2", "bn", f"{fp}/BatchNorm_2"),
                      (f"{tp}.prelu2", "prelu", f"{fp}/PReLU_1"),
                      (f"{tp}.conv3", "conv", f"{fp}/Conv_2"),
                      (f"{tp}.bn3", "bn", f"{fp}/BatchNorm_3")]
        else:
            rules += [(f"{tp}.conv1", "conv", f"{fp}/Conv_0"),
                      *bn_prelu(tp, fp, 0),
                      (f"{tp}.conv2", "conv", f"{fp}/Conv_1")]
            if kind == "asym":
                rules.append((f"{tp}.conv2b", "conv", f"{fp}/Conv_2"))
            rules += [*bn_prelu(tp, fp, 1),
                      (f"{tp}.conv3", "conv",
                       f"{fp}/Conv_{3 if kind == 'asym' else 2}"),
                      (f"{tp}.bn3", "bn", f"{fp}/BatchNorm_2")]
        rules.append((f"{tp}.prelu_out", "prelu", f"{fp}/PReLU_2"))
    return rules + [("fullconv", "deconv", "fullconv")]


def pnet_rules() -> List[Rule]:
    """PNet2D: five dilated blocks, three fusing convs and the head."""
    rules: List[Rule] = []
    for i in range(5):
        tp, fp = f"blocks.{i}", f"block{i + 1}"
        rules += [(f"{tp}.conv1", "conv", f"{fp}/Conv_0"),
                  (f"{tp}.bn1", "bn", f"{fp}/BatchNorm_0"),
                  (f"{tp}.conv2", "conv", f"{fp}/Conv_1"),
                  (f"{tp}.bn2", "bn", f"{fp}/BatchNorm_1")]
    return rules + [(name, "conv", f"Conv_{i}") for i, name in
                    enumerate(("fuse1", "fuse2", "fuse3", "out_conv"))]


_B0_STAGE_BLOCKS = (1, 2, 2, 3, 3, 4, 1)    # lukemelas b0 repeats


def efficientnet_rules(tp: str = "", fp: str = "",
                       repeats: Sequence[int] = _B0_STAGE_BLOCKS) -> List[Rule]:
    """lukemelas efficientnet_pytorch names -> chap EffiUNet's encoder
    subtree (torch_import.py:269-299 for b0), under ``tp`` / ``fp``, for
    any b0-b7 by its stages' block counts (``repeats``): the blocks
    ``_blocks.{k}`` are numbered on across the stages."""
    rules: List[Rule] = [(_join(tp, "_conv_stem"), "conv", _join(fp, "stem", "/")),
                         (_join(tp, "_bn0"), "bn", _join(fp, "BatchNorm_0", "/"))]
    k = 0
    for si, blocks in enumerate(repeats):
        for b in range(blocks):
            t, f = _join(tp, f"_blocks.{k}"), _join(fp, f"stage{si}_block{b}", "/")
            ci = 0
            if si > 0:
                rules += [(f"{t}._expand_conv", "conv", f"{f}/Conv_0"),
                          (f"{t}._bn0", "bn", f"{f}/BatchNorm_0")]
                ci = 1
            rules += [(f"{t}._depthwise_conv", "conv", f"{f}/Conv_{ci}"),
                      (f"{t}._bn1", "bn", f"{f}/BatchNorm_{ci}"),
                      (f"{t}._se_reduce", "conv", f"{f}/SqueezeExcite_0/Conv_0"),
                      (f"{t}._se_expand", "conv", f"{f}/SqueezeExcite_0/Conv_1"),
                      (f"{t}._project_conv", "conv", f"{f}/Conv_{ci + 1}"),
                      (f"{t}._bn2", "bn", f"{f}/BatchNorm_{ci + 1}")]
            k += 1
    return rules


def efficient_unet_rules(repeats: Sequence[int] = _B0_STAGE_BLOCKS) -> List[Rule]:
    """EffiUNet: the encoder (b0 by default), five decoder blocks and the
    head."""
    rules = efficientnet_rules("encoder", "encoder", repeats)
    for i in range(5):
        tp, fp = f"decoder.blocks.{i}", f"decoder{i}"
        rules += [(f"{tp}.conv1.0", "conv", f"{fp}/Conv_0"),
                  (f"{tp}.conv1.1", "bn", f"{fp}/BatchNorm_0"),
                  (f"{tp}.conv2.0", "conv", f"{fp}/Conv_1"),
                  (f"{tp}.conv2.1", "bn", f"{fp}/BatchNorm_1")]
    return rules + [("segmentation_head", "conv", "segmentation_head")]


def efficientnet_repeats(encoder: Mapping[str, Any]) -> Tuple[int, ...]:
    """A chap EfficientNetEncoder tree's block count per stage."""
    return tuple(sum(k.startswith(f"stage{si}_block") for k in encoder)
                 for si in range(len(_B0_STAGE_BLOCKS)))


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


# -- models no factory key reaches (models/{blocks, resnet, discriminator,
# extras, gan_legacy, transformer_decoder}.py, swin_unet.SwinDecoder):
# LIBRARY_FAMILIES

def _count(tree: Mapping[str, Any], prefix: str) -> int:
    """How many of ``prefix``0, ``prefix``1 ... a tree holds."""
    n = 0
    while f"{prefix}{n}" in tree:
        n += 1
    return n


def sqex_rules() -> List[Rule]:
    return [("linear1", "linear", "Dense_0"), ("linear2", "linear", "Dense_1")]


def seblock3d_rules() -> List[Rule]:
    return [("conv1", "conv", "Conv_0"), ("conv2", "conv", "Conv_1")]


def scse_rules() -> List[Rule]:
    return [("cSE.1", "conv", "Conv_0"), ("cSE.3", "conv", "Conv_1"),
            ("sSE.0", "conv", "Conv_2")]


def conv2d_relu_rules() -> List[Rule]:
    return [("block.0", "conv", "Conv_0"), ("block.1", "bn", "BatchNorm_0")]


def resnet_rules(params: Mapping[str, Any], avg_down: Optional[bool] = None,
                 layer4_dilation: int = 1) -> List[Rule]:
    """ResNetBackbone, its structure read off the tree: the deep stem
    where ``stem_conv0`` is, each stage's blocks, Bottleneck where a block
    has Conv_2, the downsample where a block has one, behind an average
    pool (``avg_down``, by default with the deep stem, as every ``_d``
    constructor) in a strided stage."""
    deep = "stem_conv0" in params
    avg_down = deep if avg_down is None else avg_down
    rules: List[Rule] = []
    if deep:
        rules += [("conv1.0", "conv", "stem_conv0"), ("conv1.1", "bn", "stem_bn0"),
                  ("conv1.3", "conv", "stem_conv1"), ("conv1.4", "bn", "stem_bn1"),
                  ("conv1.6", "conv", "conv1")]
    else:
        rules.append(("conv1", "conv", "conv1"))
    rules.append(("bn1", "bn", "bn1"))
    stages = max(int(k[len("layer"):].split("_")[0]) for k in params
                 if k.startswith("layer"))
    stage = 1
    while f"layer{stage}_block0" in params:
        strided = not (stage == stages and layer4_dilation == 2)
        b = 0
        while f"layer{stage}_block{b}" in params:
            tp, fp = f"layer{stage}.{b}", f"layer{stage}_block{b}"
            leaf = params[fp]
            n = 3 if "Conv_2" in leaf else 2
            for i in range(n):
                rules += [(f"{tp}.conv{i + 1}", "conv", f"{fp}/Conv_{i}"),
                          (f"{tp}.bn{i + 1}", "bn", f"{fp}/BatchNorm_{i}")]
            if "downsample_conv" in leaf:
                first = int(avg_down and strided)
                rules += [(f"{tp}.downsample.{first}", "conv", f"{fp}/downsample_conv"),
                          (f"{tp}.downsample.{first + 1}", "bn", f"{fp}/downsample_bn")]
            b += 1
        stage += 1
    return rules


def fc3d_discriminator_rules() -> List[Rule]:
    return [(f"conv{i}", "conv", f"conv{i}") for i in range(5)] + [
        ("classifier", "linear", "classifier")]


def fc_discriminator_rules() -> List[Rule]:
    return [(f"conv{i}", "conv", f"conv{i}") for i in range(1, 5)] + [
        ("classifier", "conv", "classifier")]


def unet_tsne_rules(params: Mapping[str, Any]) -> List[Rule]:
    """UNetTsne: the UNet under ``backbone``, and the two heads where the
    tree holds them (Flax makes a setup head's parameters only when a
    call reaches it)."""
    rules = unet2d_rules("backbone", "backbone")
    for head in ("projection_head", "prediction_head"):
        if head in params:
            rules += [(f"{head}.{i}", "linear", f"{head}/layers_{i}") for i in (0, 2)]
    return rules


def net_d_rules() -> List[Rule]:
    return [(f"fc{i + 1}", "linear", f"Dense_{i}") for i in range(3)]


def tiny_unet3d_rules() -> List[Rule]:
    rules: List[Rule] = []
    for name in ("enc1", "enc2", "enc3", "dec2", "dec1"):
        rules += [(f"{name}_conv", "conv", f"{name}_conv"),
                  (f"{name}_bn", "bn", f"{name}_bn")]
    return rules + [(n, "conv", n) for n in ("out", "ms3", "ms2")]


def _norm_after(tp: str, fp: str, bn: bool) -> List[Rule]:
    """A CycleGAN norm: BatchNorm's parameters, none for instancenorm."""
    return [(tp, "bn", fp)] if bn else []


def resnet_generator_rules(params: Mapping[str, Any], use_dropout: bool = False
                           ) -> List[Rule]:
    """ResnetGenerator's ``model`` Sequential (networks_other.py:300-351)
    over chap_tpu's auto names, the block count and the norm read off the
    tree; ``use_dropout`` moves each block's second conv and norm one
    index on."""
    n = _count(params, "_ResnetBlock_")
    c2 = 6 if use_dropout else 5
    bn = "BatchNorm_0" in params
    rules = [("model.1", "conv", "Conv_0"), *_norm_after("model.2", "BatchNorm_0", bn)]
    for i in range(2):
        rules += [(f"model.{4 + 3 * i}", "conv", f"Conv_{i + 1}"),
                  *_norm_after(f"model.{5 + 3 * i}", f"BatchNorm_{i + 1}", bn)]
    for i in range(n):
        rules += [(f"model.{10 + i}.conv_block.1", "conv", f"_ResnetBlock_{i}/Conv_0"),
                  *_norm_after(f"model.{10 + i}.conv_block.2",
                               f"_ResnetBlock_{i}/BatchNorm_0", bn),
                  (f"model.{10 + i}.conv_block.{c2}", "conv", f"_ResnetBlock_{i}/Conv_1"),
                  *_norm_after(f"model.{10 + i}.conv_block.{c2 + 1}",
                               f"_ResnetBlock_{i}/BatchNorm_1", bn)]
    for i in range(2):
        rules += [(f"model.{10 + n + 3 * i}", "deconv", f"ConvTranspose_{i}"),
                  *_norm_after(f"model.{11 + n + 3 * i}", f"BatchNorm_{i + 3}", bn)]
    return rules + [(f"model.{17 + n}", "conv", "Conv_3")]


def unet_generator_rules(params: Mapping[str, Any]) -> List[Rule]:
    """UnetGenerator: chap_tpu's blocks UnetSkipConnectionBlock_0 (the
    innermost) ... _{k} (the outermost) onto the nested ``model``
    Sequentials (networks_other.py:396-477): the outermost is ``model``,
    its submodule at index 1, each middle block's at index 3."""
    k = _count(params, "UnetSkipConnectionBlock_") - 1
    bn = "BatchNorm_0" in params["UnetSkipConnectionBlock_0"]
    rules: List[Rule] = []
    tp = "model"
    for depth in range(k + 1):
        fp = f"UnetSkipConnectionBlock_{k - depth}"
        if depth == 0:                              # outermost
            rules += [(f"{tp}.model.0", "conv", f"{fp}/Conv_0"),
                      (f"{tp}.model.3", "deconv", f"{fp}/ConvTranspose_0")]
            tp = f"{tp}.model.1"
        elif depth == k:                            # innermost
            rules += [(f"{tp}.model.1", "conv", f"{fp}/Conv_0"),
                      (f"{tp}.model.3", "deconv", f"{fp}/ConvTranspose_0"),
                      *_norm_after(f"{tp}.model.4", f"{fp}/BatchNorm_0", bn)]
        else:
            rules += [(f"{tp}.model.1", "conv", f"{fp}/Conv_0"),
                      *_norm_after(f"{tp}.model.2", f"{fp}/BatchNorm_0", bn),
                      (f"{tp}.model.5", "deconv", f"{fp}/ConvTranspose_0"),
                      *_norm_after(f"{tp}.model.6", f"{fp}/BatchNorm_1", bn)]
            tp = f"{tp}.model.3"
    return rules


def nlayer_discriminator_rules(params: Mapping[str, Any]) -> List[Rule]:
    """NLayerDiscriminator's ``model`` Sequential (networks_other.py:
    480-525): n_layers strided / final convs with their norms, the head."""
    n_layers = _count(params, "Conv_") - 2
    bn = "BatchNorm_0" in params
    rules: List[Rule] = [("model.0", "conv", "Conv_0")]
    for n in range(1, n_layers + 1):
        rules += [(f"model.{2 + 3 * (n - 1)}", "conv", f"Conv_{n}"),
                  *_norm_after(f"model.{3 + 3 * (n - 1)}", f"BatchNorm_{n - 1}", bn)]
    return rules + [(f"model.{2 + 3 * n_layers}", "conv", f"Conv_{n_layers + 1}")]


def _attention_rules(tp: str, fp: str) -> List[Rule]:
    return [(f"{tp}.{n}", "linear", f"{fp}/{n}") for n in ("q", "k", "v", "proj")] + [
        (f"{tp}.norm", "ln", f"{fp}/LayerNorm_0")]


def _query_layer_rules(params: Mapping[str, Any], cross: str) -> List[Rule]:
    """A query decoder's input projections, queries and layers: ``cross``
    (chap_tpu's cross or kmax layers), self-attention, FFN, seg head."""
    rules: List[Rule] = [(f"input_proj.{i}", "conv", f"input_proj{i}")
                         for i in range(_count(params, "input_proj"))]
    rules.append(("query_feat.weight", "raw", "query_feat"))
    if "query_embed" in params:
        rules.append(("query_embed.weight", "raw", "query_embed"))
    n_embed = _count(params, "level_embed")
    if n_embed:
        rules.append(("level_embed.weight", "stack",
                      "|".join(f"level_embed{i}" for i in range(n_embed))))
    for l in range(_count(params, cross)):
        rules += _attention_rules(f"transformer_cross_attention_layers.{l}",
                                  f"{cross}{l}")
        rules += [(f"transformer_self_attention_layers.{l}.self_attn", "mha",
                   f"self{l}/MultiHeadDotProductAttention_0"),
                  (f"transformer_self_attention_layers.{l}.norm", "ln",
                   f"self{l}/LayerNorm_0"),
                  (f"transformer_ffn_layers.{l}.linear1", "linear", f"ffn{l}/Dense_0"),
                  (f"transformer_ffn_layers.{l}.linear2", "linear", f"ffn{l}/Dense_1"),
                  (f"transformer_ffn_layers.{l}.norm", "ln", f"ffn{l}/LayerNorm_0"),
                  (f"seg_head_layers.{l}", "linear", f"seg_head{l}")]
    return rules


def mask_decoder_rules(params: Mapping[str, Any]) -> List[Rule]:
    """MaskTransformerDecoder, or V1 where the tree has its prediction
    heads (decoder_norm, class_embed, mask_embed)."""
    rules = _query_layer_rules(params, "cross")
    if "decoder_norm" in params:
        rules += [("decoder_norm", "ln", "decoder_norm"),
                  ("class_embed", "linear", "class_embed")]
        rules += [(f"mask_embed.layers.{i}", "linear", f"mask_embed/Dense_{i}")
                  for i in range(_count(params["mask_embed"], "Dense_"))]
    return rules


def kmax_decoder_rules(params: Mapping[str, Any]) -> List[Rule]:
    return _query_layer_rules(params, "kmax")


# family -> rules(params, **options), the structure read off the tree and
# the options (resnet: avg_down, layer4_dilation; resnet_generator:
# use_dropout), which the tree does not show
LIBRARY_FAMILIES = {
    "sqex": lambda p: sqex_rules(), "seblock3d": lambda p: seblock3d_rules(),
    "scse": lambda p: scse_rules(), "conv2d_relu": lambda p: conv2d_relu_rules(),
    "resnet": resnet_rules,
    "fc3d_discriminator": lambda p: fc3d_discriminator_rules(),
    "fc_discriminator": lambda p: fc_discriminator_rules(),
    "unet_2dbcp": lambda p: unet2d_rules(), "unet_tsne": unet_tsne_rules,
    "net_d": lambda p: net_d_rules(), "tiny_unet3d": lambda p: tiny_unet3d_rules(),
    "resnet_generator": resnet_generator_rules,
    "unet_generator": unet_generator_rules,
    "nlayer_discriminator": nlayer_discriminator_rules,
    "mask_decoder": mask_decoder_rules, "kmax_decoder": kmax_decoder_rules,
    "swin_decoder": swin_decoder_rules,
}


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


FAMILIES_2D = {"unet": unet2d_rules, "unetp": unetp_rules,
               "unet_cct": unet_cct_rules, "unet_urpc": unet_urpc_rules,
               "resunet": resunet_rules, "dual_student": dsnet_rules,
               "swinunet": swinunet_rules, "enet": enet_rules,
               "pnet": pnet_rules, "efficient_unet": efficient_unet_rules}
FAMILIES_3D = {"vnet": vnet_rules, "vnet_ds": vnet_ds_rules,
               "dualdecoder3d": dualdecoder3d_rules, "resvnet": resvnet_rules,
               "unet_3D": unet3d_rules, "unet_3D_dv_semi": unet3d_dv_rules,
               "attention_unet": attention_unet_rules,
               "voxresnet": voxresnet_rules}
_NORMALIZED = ("vnet", "vnet_ds", "dualdecoder3d", "resvnet")


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         decoder_type: str = "mcnet", family: str = "dualdecoder",
                         normalization: Optional[str] = None, **options
                         ) -> Dict[str, torch.Tensor]:
    """Flax variables (numpy trees) -> the port's state_dict. ``family``:
    ``dualdecoder`` or ``acalnet`` (2D, the same model, with
    ``decoder_type``), every other 2D net_factory key (FAMILIES_2D; a
    SwinUNet's depths are read off its tree); in 3D ``vnet``, ``vnet_ds``, ``dualdecoder3d`` or
    ``resvnet`` (with ``normalization``, by default batchnorm and for resvnet
    instancenorm) and
    ``unet_3D``, ``unet_3D_dv_semi``, ``attention_unet`` or ``voxresnet``;
    the models no factory key builds, by LIBRARY_FAMILIES (``options`` as
    it lists them). ``batch_stats`` may be empty for a model without
    BatchNorm."""
    if family in ("dualdecoder", "acalnet"):
        rules = dualdecoder_rules(decoder_type)
    elif family == "swinunet":
        rules = swinunet_rules(_swin_depths(params))
    elif family == "efficient_unet":
        rules = efficient_unet_rules(efficientnet_repeats(params["encoder"]))
    elif family in FAMILIES_2D:
        rules = FAMILIES_2D[family]()
    elif family in LIBRARY_FAMILIES:
        rules = LIBRARY_FAMILIES[family](params, **options)
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
        leaf = None if kind == "stack" else _get(params, fp)
        if kind in ("conv", "deconv"):
            to_torch = _conv_weight if kind == "conv" else _deconv_weight
            sd[f"{tp}.weight"] = _t(to_torch(np.asarray(leaf["kernel"])))
            if "bias" in leaf:
                sd[f"{tp}.bias"] = _t(leaf["bias"])
        elif kind == "linear":
            sd[f"{tp}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"])))
            if "bias" in leaf:
                sd[f"{tp}.bias"] = _t(leaf["bias"])
        elif kind in ("gn", "ln"):
            sd[f"{tp}.weight"] = _t(leaf["scale"])
            sd[f"{tp}.bias"] = _t(leaf["bias"])
        elif kind == "prelu":
            sd[f"{tp}.weight"] = _t(np.reshape(leaf["negative_slope"], (1,)))
        elif kind == "raw":
            sd[tp] = _t(leaf)
        elif kind == "stack":       # a row a path, e.g. per-level embeddings
            sd[tp] = torch.stack([_t(np.reshape(_get(params, f), (-1,)))
                                  for f in fp.split("|")])
        elif kind == "mha":         # Flax MultiHeadDotProductAttention
            proj = [np.asarray(leaf[n]["kernel"]) for n in ("query", "key", "value")]
            sd[f"{tp}.in_proj_weight"] = torch.cat(
                [_t(k.reshape(k.shape[0], -1).T) for k in proj])
            sd[f"{tp}.in_proj_bias"] = torch.cat(
                [_t(np.reshape(leaf[n]["bias"], (-1,))) for n in ("query", "key", "value")])
            out = np.asarray(leaf["out"]["kernel"])
            sd[f"{tp}.out_proj.weight"] = _t(out.reshape(-1, out.shape[-1]).T)
            sd[f"{tp}.out_proj.bias"] = _t(leaf["out"]["bias"])
        else:   # bn
            stats = _get(batch_stats, fp)
            sd[f"{tp}.weight"] = _t(leaf["scale"])
            sd[f"{tp}.bias"] = _t(leaf["bias"])
            sd[f"{tp}.running_mean"] = _t(stats["mean"])
            sd[f"{tp}.running_var"] = _t(stats["var"])
            sd[f"{tp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
