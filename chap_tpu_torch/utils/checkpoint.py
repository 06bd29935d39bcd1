"""Checkpointing of the full train state (port of
chap_tpu/utils/checkpoint.py, torch-native: no orbax, no flax).

The reference saves model weights only (latest.pth every eval plus
{model}_best_model.pth on val improvement, train_ours_2D.py:428-435), with no
optimizer state, step counter or resume path. A slot here holds the whole
TrainState, so an interrupted run resumes exactly:
  * the model ``state_dict`` (parameters and BN running stats),
  * the optimizer ``state_dict`` (SGD momentum buffers),
  * the GradSim ``sim_scores`` and the ``step``.

Layout, as chap_tpu's: ``<snapshot>/checkpoints/{latest,best}/`` with one
``state.pt`` each, and ``meta.json`` (best metric and iteration) beside the
slots. Every file is written to a temporary name and then ``os.replace``d,
so a slot is either the old state or the new one.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from chap_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    """latest/best two-slot checkpointing in <snapshot>/checkpoints."""

    def __init__(self, snapshot_path: str):
        self.root = os.path.abspath(os.path.join(snapshot_path, "checkpoints"))
        os.makedirs(self.root, exist_ok=True)

    def _file(self, name: str) -> str:
        return os.path.join(self.root, name, STATE_FILE)

    def save(self, name: str, state: TrainState) -> None:
        path = self._file(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        payload = {"step": int(state.step),
                   "model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "sim_scores": list(state.sim_scores)}
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)

    def save_latest(self, state: TrainState) -> None:
        self.save("latest", state)

    def save_best(self, state: TrainState) -> None:
        self.save("best", state)

    def restore(self, name: str, state: TrainState) -> TrainState:
        """Load slot ``name`` into ``state`` (its model, optimizer, scores
        and step, in place) and return it. Tensors land on the device of the
        state's model."""
        device = next(state.model.parameters()).device
        payload = torch.load(self._file(name), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.sim_scores = list(payload["sim_scores"])
        state.step = int(payload["step"])
        return state

    def has(self, name: str) -> bool:
        return os.path.isfile(self._file(name))

    def restore_latest(self, state: TrainState) -> Optional[TrainState]:
        if self.has("latest"):
            return self.restore("latest", state)
        return None

    # -- run metadata sidecar (meta.json next to the slots) ------------------

    def _meta_path(self) -> str:
        return os.path.join(self.root, "meta.json")

    def save_meta(self, meta: Dict[str, Any]) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._meta_path())

    def load_meta(self) -> Dict[str, Any]:
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                return json.load(f)
        return {}
