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
import re
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

from repro_torch.compiles import note_compile

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_bwd",
           "decode_attention", "gbt_hist")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _tool(name: str = "nvcc") -> str:
    """A program of the CUDA toolkit that builds the kernels."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put "
                           "nvcc on PATH to build the repro_torch kernels")
    return str(Path(CUDA_HOME) / "bin" / name)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()
    return BUILD_DIR / f"{name}-{digest[:12]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compiles every source of ``names`` not built yet, one ``nvcc`` per
    source, all started together.  Returns each compiled source's
    ``-Xptxas -v`` report; raises with the compiler's output on failure.
    Each source compiled counts as one compilation for
    ``staticcheck.tracers.assert_max_compiles``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    jobs = {}
    try:
        for name in names:
            out = library_path(name)
            if out.exists():
                continue
            nvcc = nvcc or _tool()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode == 0:
                out.with_suffix(".log").write_text(logs[name])
                os.replace(tmp, out)
                note_compile("build")
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


def ptxas_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the built ``csrc/<name>.cu``, kept
    beside the library when it was compiled.  Builds the source first."""
    build((name,))
    return library_path(name).with_suffix(".log").read_text()


def ptxas_report(name: str) -> Dict[str, Tuple[int, int]]:
    """(registers, bytes of spill stores) of each entry function of the
    built ``csrc/<name>.cu``, by mangled name, from its ptxas report."""
    rows, fn, spill = {}, None, 0
    for line in ptxas_log(name).splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and fn:
            rows[fn] = (int(line.split("Used")[1].split("registers")[0]), spill)
            fn = None
    return rows


def tensor_core_kinds(name: str) -> Dict[str, Dict[str, int]]:
    """For each entry function of the built ``csrc/<name>.cu``, by mangled
    name: how many ``HMMA`` (``mma.sync``) and ``HGMMA`` (``wgmma``)
    instructions its SASS holds, as ``cuobjdump -sass`` prints it.  Builds
    the source first."""
    build((name,))
    sass = subprocess.run([_tool("cuobjdump"), "-sass", str(library_path(name))],
                          capture_output=True, text=True, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m[1]
            counts[fn] = {"HMMA": 0, "HGMMA": 0}
        elif fn and (m := re.search(r"\b(HG?MMA)\.", line)):
            counts[fn][m[1]] += 1
    return counts


def tensor_core_counts(name: str) -> Dict[str, int]:
    """For each entry function of the built ``csrc/<name>.cu``, by mangled
    name: how many tensor-core instructions (``HMMA`` and ``HGMMA``) its
    SASS holds."""
    return {fn: sum(n.values()) for fn, n in tensor_core_kinds(name).items()}


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
