"""ctypes binding of the CUDA flash-attention kernel.

The kernel is ``csrc/flash_attention.cu`` (its header comment says what it
replaces and what bounds it); it is compiled at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 12
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_bshd(q, k, v, out, causal: bool, scale: float) -> None:
    """q/out: (B, S, H, Dh); k/v: (B, Sk, KV, Dh), checked by the caller."""
    lib, fn = _entry()
    b, s, h, dh = q.shape
    sk, kv = k.shape[1:3]
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _build.dtype_code(q, k, v, out), b, s, sk, h, kv, dh, *strides,
              scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention")
