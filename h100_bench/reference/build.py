"""The reference's models, optimizer, train state and steps, built from the
reference's own config tree as the port's factories and trainers build
theirs (``models/factory.py``, ``train/trainer_2d.py``, ``trainer_3d.py``).

``PRECISIONS`` names how the reference computes: ``float32`` is the
comparison side (the caller turns TF32 off), ``bfloat16`` and ``float8``
are the controls a precision below each configuration's own.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from h100_bench.reference.config import Config
from h100_bench.reference.models.layers import set_compute_dtype, set_fp8_operands
from h100_bench.reference.models.unet2d import DualDecoder
from h100_bench.reference.models.vnet3d import DualDecoder3d
from h100_bench.reference.semi.gradsim import ENCODER_LEVEL_PATHS, VNET_LEVEL_PATHS
from h100_bench.reference.train.state import create_train_state, make_optimizer
from h100_bench.reference.train.step_chap import build_chap_train_step, level_channels
from h100_bench.reference.train.step_supervised import build_supervised_train_step

PRECISIONS = ("float32", "bfloat16", "float8")


def build_model(cfg: Config, rank: int, train: bool, precision: str,
                device: torch.device) -> torch.nn.Module:
    """The configuration's DualDecoder (``rank`` 2) or DualDecoder3d (3,
    dropout in train mode only, as net_factory_3d's ``mode``)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    if rank == 2:
        model = DualDecoder(cfg.data.in_chns, cfg.data.num_classes,
                            cfg.model.decoder_type,
                            feature_chns=tuple(cfg.model.feature_chns),
                            dropout=tuple(cfg.model.dropout))
    else:
        model = DualDecoder3d(cfg.data.in_chns, cfg.data.num_classes,
                              n_filters=cfg.model.n_filters_3d,
                              normalization=cfg.model.normalization_3d,
                              has_dropout=train)
    dtype = torch.float32 if precision == "float32" else torch.bfloat16
    set_compute_dtype(model, dtype)
    if precision == "float8":
        set_fp8_operands(model)
    return model.to(device)


def build_train(cfg: Config, rank: int, mode: str, precision: str,
                device: torch.device,
                params: Dict[str, torch.Tensor],
                record: Optional[Dict[str, list]] = None) -> tuple:
    """(state, step) of a train cell: the model with ``params`` loaded by
    name, SGD, the train state and the ``mode`` step (``chap`` or
    ``supervised``); ``record`` as build_chap_train_step takes it."""
    model = build_model(cfg, rank, True, precision, device)
    load_params(model, params)
    optimizer = make_optimizer(model, cfg.optim.base_lr, cfg.optim.momentum,
                               cfg.optim.weight_decay)
    if mode == "chap":
        state = create_train_state(model, optimizer, level_channels(cfg, rank))
        step = build_chap_train_step(
            model, optimizer, cfg, use_nms=True,
            level_paths=ENCODER_LEVEL_PATHS if rank == 2 else VNET_LEVEL_PATHS,
            device=device, record=record)
    elif mode == "supervised":
        state = create_train_state(model, optimizer)
        step = build_supervised_train_step(model, optimizer, cfg, device=device)
    else:
        raise ValueError(f"unknown train mode {mode!r}")
    return state, step


def load_params(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Copy ``params`` (name -> tensor) into the model's parameters; every
    parameter must be named, with its shape."""
    own = dict(model.named_parameters())
    if set(own) != set(params):
        raise ValueError(f"parameter names differ: "
                         f"{sorted(set(own) ^ set(params))[:5]}")
    with torch.no_grad():
        for name, p in own.items():
            p.copy_(params[name])
