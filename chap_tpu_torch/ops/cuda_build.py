"""Build and load the port's CUDA C++ kernels (csrc/*.cu).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface and loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds. The build runs at first use into
``build/kernels/`` at the repository root (listed in .gitignore), named by a
hash of the source and flags, so a changed source is rebuilt and a finished
library is reused within one checkout.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "are built on the machine with the card")
    return found


def library_path(source: str) -> Path:
    text = (CSRC / source).read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}_{digest[:12]}.so"


def build(source: str) -> dict:
    """Compile csrc/<source> unless its library exists. Returns the library
    path, the seconds spent and nvcc's output (-Xptxas=-v resource use)."""
    so = library_path(source)
    if so.exists():
        log = so.with_suffix(".log")
        return {"path": str(so), "seconds": 0.0,
                "log": log.read_text() if log.exists() else ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source} ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    log = proc.stdout + proc.stderr
    so.with_suffix(".log").write_text(log)
    os.replace(tmp, so)
    return {"path": str(so), "seconds": seconds, "log": log}


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(source)["path"])
