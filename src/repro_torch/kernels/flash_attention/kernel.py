"""ctypes binding of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward
(``csrc/flash_attention_bwd.cu``); their header comments say what they
replace and what bounds them.  Each is compiled at its first launch.
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
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


@functools.cache
def _bwd_entry():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 24
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def flash_attention_bshd(q, k, v, out, causal: bool, scale: float,
                         lse=None) -> None:
    """q/out: (B, S, H, Dh); k/v: (B, Sk, KV, Dh); lse None or a contiguous
    (B, H, S) float32 buffer for the rows' log-sum-exp; checked by the
    caller."""
    lib, fn = _entry()
    b, s, h, dh = q.shape
    sk, kv = k.shape[1:3]
    strides = [x for t in (q, k, v, out) for x in t.stride()[:3]]
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              _build.dtype_code(q, k, v, out), b, s, sk, h, kv, dh, *strides,
              scale, int(causal), None if lse is None else lse.data_ptr(),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention")


def flash_attention_bwd_bshd(q, k, v, out, dout, lse, dq, dk, dv,
                             causal: bool, scale: float) -> None:
    """q, out, dout, dq: (B, S, H, Dh); k, v, dk, dv: (B, Sk, KV, Dh); lse:
    the forward's contiguous (B, H, S) float32; checked by the caller."""
    lib, fn = _bwd_entry()
    b, s, h, dh = q.shape
    sk, kv = k.shape[1:3]
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = [x for t in (q, k, v, out, dout, dq, dk, dv)
               for x in t.stride()[:3]]
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
              dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              _build.dtype_code(q, k, v, out, dout, dq, dk, dv),
              b, s, sk, h, kv, dh, *strides, scale, int(causal),
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "flash_attention_bwd")
