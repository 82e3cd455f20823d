"""ctypes binding of the CUDA decode-attention kernel.

The kernel is ``csrc/decode_attention.cu`` (its header comment says what it
replaces and what bounds it); it is compiled at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

@functools.cache
def _entry():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_int64] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def decode_attention_bhd(q, k, v, out, pos: int, scale: float) -> None:
    """q/out: (B, H, Dh); k/v: (B, T, KV, Dh), checked by the caller."""
    lib, fn = _entry()
    b, h, dh = q.shape
    kv = k.shape[2]
    strides = (*q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:2])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _build.dtype_code(q, k, v, out), b, kv, h // kv, dh, pos,
              *strides, scale, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "decode_attention")
