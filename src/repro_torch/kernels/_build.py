"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and includes no PyTorch
header, so ``nvcc`` compiles it in seconds into ``build/repro_torch/`` at
the repository root, where it is loaded with ``ctypes``.  The library's
file name carries a digest of its source and flags, so an edited source is
rebuilt and a built one is reused.  Nothing is compiled at import time.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("flash_attention", "decode_attention", "gbt_hist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH to build the repro_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compiles every source of ``names`` not built yet, one ``nvcc`` per
    source, all started together.  Returns each compiled source's
    ``-Xptxas -v`` report; raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                os.replace(tmp, out)
            else:
                failed.append(f"nvcc failed on {name}.cu:\n{logs[name]}")
        if failed:
            raise RuntimeError("\n".join(failed))
        return logs
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, compiled first if needed."""
    build((name,))
    lib = ctypes.CDLL(str(library_path(name)))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raises if a launch returned a CUDA error code other than 0."""
    if code != 0:
        msg = lib.error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128)  # the head sizes csrc/*.cu instantiate


def dtype_code(*tensors) -> int:
    """The kernels' code for the common dtype of ``tensors``; raises unless
    all share float32 or bfloat16."""
    dtypes = {t.dtype for t in tensors}
    if len(dtypes) != 1 or not dtypes <= DTYPE_CODES.keys():
        raise TypeError(f"expected one dtype, float32 or bfloat16; got "
                        f"{sorted(map(str, dtypes))}")
    return DTYPE_CODES[dtypes.pop()]


def check_strided(name: str, t, device) -> None:
    """Raises unless ``t`` lies on ``device`` with a contiguous last dim and
    every row start 16-byte aligned, as the kernels' vector loads need."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: last dimension must be contiguous")
    item = t.element_size()
    if t.data_ptr() % 16 or any(s * item % 16 for s in t.stride()[:-1]):
        raise ValueError(f"{name}: data pointer and strides {t.stride()} "
                         f"must be 16-byte aligned")
