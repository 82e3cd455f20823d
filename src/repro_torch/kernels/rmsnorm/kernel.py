"""ctypes binding of the CUDA RMSNorm kernels (plain, fused with the
residual add, and their backward).

The kernels are ``csrc/rmsnorm.cu`` (its header comment says what they
replace and what bounds them); they are compiled at the first launch.
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
    bwd = lib.rmsnorm_bwd
    bwd.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                    + [ctypes.c_float, ctypes.c_void_p])
    bwd.restype = ctypes.c_int
    lib.rmsnorm_bwd_partials.argtypes = [ctypes.c_int] * 3
    lib.rmsnorm_bwd_partials.restype = ctypes.c_int
    return lib, fn, bwd


def rmsnorm_rows(x, r, scale, s, y, eps: float) -> None:
    """x, r: contiguous (..., d) on one card, r None for the plain norm;
    s, y: outputs like x (s None for the plain norm); scale: contiguous
    (d,).  Checked by the caller, apart from x's and r's dtypes."""
    lib, fn, _ = _entry()
    d = x.shape[-1]
    code = fn(x.data_ptr(), None if r is None else r.data_ptr(),
              scale.data_ptr(), None if s is None else s.data_ptr(),
              y.data_ptr(),
              _build.dtype_code(x) if r is None else _build.dtype_code(x, r),
              _build.DTYPE_CODES[scale.dtype], x.numel() // d, d, eps,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "rmsnorm")


def rmsnorm_bwd_rows(x, scale, dy, ds, dx, dscale, eps: float) -> None:
    """x, dy, dx (and ds, None for the plain norm): contiguous (..., d) of
    one dtype on one card; scale: contiguous (d,); dscale: float32 (d,).
    The per-block partial sums of dscale go to a scratch buffer allocated
    here; checked by the caller, apart from the dtypes."""
    lib, _, fn = _entry()
    d = x.shape[-1]
    n = x.numel() // d
    parts = lib.rmsnorm_bwd_partials(n, d, _build.dtype_code(x))
    if parts <= 0:
        raise ValueError(f"rmsnorm_bwd: rows of {d} {x.dtype} values are "
                         f"wider than the kernel takes")
    work = torch.empty((parts, d), dtype=torch.float32, device=x.device)
    tensors = (x, dy, dx) if ds is None else (x, dy, ds, dx)
    code = fn(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
              None if ds is None else ds.data_ptr(), dx.data_ptr(),
              dscale.data_ptr(), work.data_ptr(),
              _build.dtype_code(*tensors), _build.DTYPE_CODES[scale.dtype],
              n, d, parts, eps,
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "rmsnorm_bwd")
