"""Experiment run-dir management (a copy of chap_tpu/utils/launch.py, kept
here so the port never imports the JAX package).

The reference's ``utils.launch.init_save_folder`` contract
(train_ours_2D.py:558; run-id layout of test_2D_fully.py:102-103): creates
and returns ``<snapshot>/<model>/run_N`` with N the first free index.
"""
from __future__ import annotations

import json
import logging
import os
import pprint
import sys

import numpy as np
import torch

from chap_tpu_torch.parallel import dist


def init_save_folder(snapshot_path: str, model: str,
                     reuse_last: bool = False) -> str:
    """reuse_last=True (the CLIs' --resume path) returns the LAST existing
    run_N instead of allocating a fresh one — a resumed run must land in the
    directory that holds its checkpoints (CheckpointManager restores from
    the run dir it is given)."""
    base = os.path.join(snapshot_path, model)
    os.makedirs(base, exist_ok=True)
    n = 0
    while os.path.exists(os.path.join(base, f"run_{n}")):
        n += 1
    if reuse_last and n > 0:
        return os.path.join(base, f"run_{n - 1}")
    run_dir = os.path.join(base, f"run_{n}")
    os.makedirs(run_dir)
    return run_dir


def setup_logging(save_dir: str) -> None:
    # log.txt + stdout, matching train_ours_2D.py:567-570
    logging.basicConfig(
        filename=os.path.join(save_dir, "log.txt"),
        level=logging.INFO,
        format="[%(asctime)s.%(msecs)03d] %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )
    logging.getLogger().addHandler(logging.StreamHandler(sys.stdout))


def _provenance_path(save_dir: str, name: str, ext: str) -> str:
    """First free provenance filename: <name>.<ext>, then <name>.resume1.<ext>,
    ... — a resumed run (possibly with different flags) must not silently
    overwrite the original segment's recorded provenance."""
    path = os.path.join(save_dir, f"{name}.{ext}")
    n = 1
    while os.path.exists(path):
        path = os.path.join(save_dir, f"{name}.resume{n}.{ext}")
        n += 1
    return path


def write_doc(save_dir: str, text: str) -> None:
    # free-text experiment description, matching train_ours_2D.py:562-565
    with open(_provenance_path(save_dir, "doc", "txt"), "w") as f:
        f.write(text)


def dump_config(save_dir: str, cfg_dict: dict) -> None:
    # experiment provenance: persist the resolved config instead of copying
    # the training script (reference copies train_*.py, train_ours_2D.py:559)
    with open(_provenance_path(save_dir, "config", "json"), "w") as f:
        json.dump(cfg_dict, f, indent=2, default=str)


def open_run_dir(snapshot_path: str, model: str, reuse_last: bool, text: str,
                 cfg_dict: dict, device: torch.device) -> str:
    """A training CLI's run dir ``<snapshot_path>/<model>/run_N`` on every
    rank: rank 0 picks it (``init_save_folder``), writes doc.txt and
    config.json, starts log.txt and logs the config and the process group;
    the other ranks get its path by broadcast and write nothing."""
    run = 0
    if dist.is_main():
        os.makedirs(snapshot_path, exist_ok=True)
        run = int(init_save_folder(snapshot_path, model, reuse_last)
                  .rsplit("_", 1)[1])
    save_dir = os.path.join(snapshot_path, model, "run_%d" % (
        dist.broadcast_array(np.array([run]), device)[0]))
    if dist.is_main():
        write_doc(save_dir, text)
        dump_config(save_dir, cfg_dict)
        setup_logging(save_dir)
        logging.info("%s", pprint.pformat(cfg_dict))
        logging.info("data parallel: %s, device %s", dist.describe(), device)
    return save_dir
