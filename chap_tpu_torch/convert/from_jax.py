"""Carry chap_tpu (Flax) weights into the port's torch modules.

``state_dict_from_flax`` inverts chap_tpu/convert/torch_import.py: it walks
the same DualDecoder rule table (a copy of torch_import.py:43-82, so the
port needs nothing of chap_tpu) and undoes the layout rules of
torch_import.py:358-372:
    conv    Flax (kh, kw, I, O)                    -> torch [O, I, kh, kw]
    deconv  Flax (kh, kw, I, O), spatially flipped -> torch [I, O, kh, kw]
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


def _get(tree: Mapping[str, Any], path: str) -> Mapping[str, Any]:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def state_dict_from_flax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                         decoder_type: str = "mcnet") -> Dict[str, torch.Tensor]:
    """Flax DualDecoder variables (numpy trees) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    for tp, kind, fp in dualdecoder_rules(decoder_type):
        leaf = _get(params, fp)
        if kind == "conv":
            sd[f"{tp}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"]),
                                                 (3, 2, 0, 1)))
            sd[f"{tp}.bias"] = _t(leaf["bias"])
        elif kind == "deconv":
            k = np.asarray(leaf["kernel"])[::-1, ::-1]
            sd[f"{tp}.weight"] = _t(np.transpose(k, (2, 3, 0, 1)))
            sd[f"{tp}.bias"] = _t(leaf["bias"])
        else:   # bn
            stats = _get(batch_stats, fp)
            sd[f"{tp}.weight"] = _t(leaf["scale"])
            sd[f"{tp}.bias"] = _t(leaf["bias"])
            sd[f"{tp}.running_mean"] = _t(stats["mean"])
            sd[f"{tp}.running_var"] = _t(stats["var"])
            sd[f"{tp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd
