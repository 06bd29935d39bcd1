"""Scalar metric logging: JSONL always + TensorBoard when available (a copy
of chap_tpu/utils/metrics_writer.py, kept here so the port never imports the
JAX package; tensorboardX stays optional).

Replaces the reference's tensorboardX scalars (train_ours_2D.py:292,391-401)
and pandas val.csv appends (:437-449) with one writer that emits a
machine-readable metrics.jsonl and mirrors to TensorBoard when tensorboardX
is importable.
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict

try:
    from tensorboardX import SummaryWriter as _TBWriter
except ImportError:  # pragma: no cover
    _TBWriter = None


class MetricsWriter:
    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = _TBWriter(os.path.join(log_dir, "tb")) \
            if (use_tensorboard and _TBWriter is not None) else None

    def write(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), int(step))

    def append_csv(self, path: str, row: Dict) -> None:
        """val.csv-style append (train_ours_2D.py:442-449)."""
        header = not os.path.exists(path)
        with open(path, "a") as f:
            if header:
                f.write(",".join(row.keys()) + "\n")
            f.write(",".join(str(v) for v in row.values()) + "\n")

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
