"""Reference PyTorch checkpoints (``.pth`` state dicts) into the port's
models (port of chap_tpu/convert/torch_import.py).

The reference saves bare ``model.state_dict()`` files
(train_ours_2D.py:428-435; loaded at test_2D_fully.py:115-117,
test_LA.py:44-46). chap_tpu maps them onto Flax trees by rule tables; the
port's modules carry the reference's names, so here a checkpoint loads by
name, with what chap_tpu does around its rules:
  * ``{"state_dict": ...}`` wrappers and DataParallel ``module.`` prefixes
    are unwrapped (chap_tpu/cli/convert_torch.py:35-42);
  * every tensor of the model must come from the checkpoint, shapes equal
    (the BatchNorms' ``num_batches_tracked`` counters may be absent);
  * a checkpoint key the model does not take is refused, but the
    counters, Swin's ``relative_position_index`` / ``attn_mask``
    buffers and, for swinunet, its empty ``projector.`` keys
    (torch_import.py:488-495).
The ImageNet encoders of the pretrained recipes load leniently:
``convert_efficientnet_pretrained`` (patch_first_conv for 1, 2 or 3 input
channels) and ``convert_swin_pretrained`` (the load_from surgery that
mirrors encoder stages into the decoder, mismatched entries dropped).
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

IGNORED_BUFFERS = ("num_batches_tracked", "relative_position_index", "attn_mask")


def _tensor(v: Any) -> torch.Tensor:
    return v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))


def unwrap_state_dict(obj: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A checkpoint's state dict: ``{"state_dict": ...}`` unwrapped and
    ``module.`` prefixes dropped; numpy arrays become tensors."""
    if "state_dict" in obj:
        obj = obj["state_dict"]
    return {k[len("module."):] if k.startswith("module.") else k: _tensor(v)
            for k, v in obj.items()}


def read_pth(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth`` file's state dict (tensors only: weights_only), unwrapped."""
    return unwrap_state_dict(torch.load(path, map_location="cpu", weights_only=True))


def _assemble(model: nn.Module, state_dict: Mapping[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
    """Every tensor of ``model``'s state dict from ``state_dict``: a missing
    key (but a BatchNorm counter, which keeps the model's) raises KeyError,
    a shape that differs ValueError."""
    out = {}
    for key, own in model.state_dict().items():
        if key not in state_dict:
            if key.endswith("num_batches_tracked"):
                out[key] = own
                continue
            raise KeyError(f"checkpoint has no {key!r}")
        value = state_dict[key]
        if tuple(value.shape) != tuple(own.shape):
            raise ValueError(f"{key}: shape {tuple(value.shape)} != the model's "
                             f"{tuple(own.shape)}")
        out[key] = value.to(own.dtype)
    return out


def load_reference_state_dict(model: nn.Module, state_dict: Mapping[str, Any],
                              family: str = "") -> nn.Module:
    """Load a reference-named state dict into ``model`` (in place, on its
    device) and return it. ``family`` names chap_tpu's converter family
    (``swinunet`` ignores the ``projector.`` keys); a key the model does
    not take raises ValueError."""
    sd = unwrap_state_dict(state_dict)
    own = model.state_dict()
    skip = ("projector.",) if family == "swinunet" else ()
    leftovers = [k for k in sd if k not in own and not k.endswith(IGNORED_BUFFERS)
                 and not k.startswith(skip)]
    if leftovers:
        raise ValueError(f"{len(leftovers)} checkpoint keys not consumed, e.g. "
                         f"{leftovers[:8]}")
    model.load_state_dict(_assemble(model, sd))
    return model


def convert_efficientnet_pretrained(state_dict: Mapping[str, Any], model: nn.Module,
                                    in_chns: int = 1) -> nn.Module:
    """An ImageNet EfficientNet checkpoint (lukemelas names) into the
    encoder of ``model`` (an EffiUNet, or an encoder itself); the decoder
    keeps its weights, the classifier head's keys are ignored
    (efficient_encoder.py:78,105-109). patch_first_conv
    (efficient_encoder.py:36-67): for 1 input channel the stem kernel is
    summed over its 3, for 2 the first two are kept and scaled by 3 / 2;
    other counts than 1, 2 and 3 raise (the reference re-initialises
    them, which is training from scratch)."""
    sd = unwrap_state_dict(state_dict)
    w = sd["_conv_stem.weight"]                 # [O, 3, kh, kw]
    if in_chns == 1:
        sd["_conv_stem.weight"] = w.sum(1, keepdim=True)
    elif in_chns == 2:
        sd["_conv_stem.weight"] = w[:, :2] * (3.0 / 2.0)
    elif in_chns != 3:
        raise ValueError("patch_first_conv supports in_chns in (1, 2, 3); "
                         f"got {in_chns} (the reference re-initializes >3, "
                         "which equals training from scratch)")
    encoder = getattr(model, "encoder", model)
    encoder.load_state_dict(_assemble(encoder, sd))
    return model


def swin_encoder_surgery(state_dict: Mapping[str, Any],
                         num_layers: int = 4) -> Dict[str, Any]:
    """The reference's load_from surgery (vision_transformer.py:71-87):
    every encoder key ``layers.{i}...`` also initialises the mirrored
    decoder stage ``layers_up.{num_layers - 1 - i}...``."""
    full = dict(state_dict)
    for k, v in state_dict.items():
        if k.startswith("layers."):
            full[f"layers_up.{num_layers - 1 - int(k[7])}" + k[8:]] = v
    return full


def convert_swin_pretrained(state_dict: Mapping[str, Any], model: nn.Module
                            ) -> nn.Module:
    """An official ImageNet Swin encoder checkpoint into a SwinUNet, the
    reference's load_from (vision_transformer.py:55-90): ``{"model": ...}``
    unwrapped, the encoder mirrored into the decoder, then a lenient load:
    a module's tensors load where the checkpoint holds all of them at the
    model's shapes, the rest keeps its weights. A checkpoint that fills no
    encoder stage raises ValueError."""
    if "model" in state_dict:
        state_dict = state_dict["model"]
    full = swin_encoder_surgery(unwrap_state_dict(state_dict), len(model.layers))
    own = model.state_dict()
    groups: Dict[str, list] = {}
    for key in own:
        if not key.endswith(IGNORED_BUFFERS):
            groups.setdefault(key.rpartition(".")[0], []).append(key)
    load = {}
    for keys in groups.values():
        if all(k in full and tuple(full[k].shape) == tuple(own[k].shape) for k in keys):
            load.update({k: full[k].to(own[k].dtype) for k in keys})
    if not any(k.startswith("layers.") for k in load):
        raise ValueError("no encoder weights matched — is this a Swin checkpoint?")
    model.load_state_dict(load, strict=False)
    return model
