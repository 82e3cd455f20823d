"""ctypes binding of the CUDA RMSNorm kernel (plain, and fused with the
residual add).

The kernel is ``csrc/rmsnorm.cu`` (its header comment says what it
replaces and what bounds it); it is compiled at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    lib = _build.load("rmsnorm")
    fn = lib.rmsnorm_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def rmsnorm_rows(x, r, scale, s, y, eps: float) -> None:
    """x, r: contiguous (..., d) on one card, r None for the plain norm;
    s, y: outputs like x (s None for the plain norm); scale: contiguous
    (d,).  Checked by the caller, apart from x's and r's dtypes."""
    lib, fn = _entry()
    d = x.shape[-1]
    code = fn(x.data_ptr(), None if r is None else r.data_ptr(),
              scale.data_ptr(), None if s is None else s.data_ptr(),
              y.data_ptr(),
              _build.dtype_code(x) if r is None else _build.dtype_code(x, r),
              _build.DTYPE_CODES[scale.dtype], x.numel() // d, d, eps,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "rmsnorm")
