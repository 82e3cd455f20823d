"""ctypes binding of the CUDA flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward
(``csrc/flash_attention_bwd.cu``); their header comments say what they
replace and what bounds them.  Each is compiled at its first launch.

The bf16 forward is persistent: it launches ``min(items, SMs)`` blocks,
and each walks the work items (128 query rows of one head of one
sequence) by a fixed stride, heaviest first.  ``work_items``,
``persistent_plan`` and ``fwd_smem_bytes`` mirror that walk and the
block's shared memory in Python.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

ROWS = 128            # query rows a work item: two consumer warpgroups
KEYS = 64             # keys a K/V tile
MAX_STAGES = 8        # the K/V ring's depth at most
SMEM_MAX = 232_448    # a block's shared memory on Hopper
THREADS = 384         # a producer warpgroup and the two consumers
BF16_BYTES = 2


def work_items(b: int, sq: int, h: int):
    """(q0, b, h) of every work item of a call over ``b`` sequences of
    ``sq`` query rows and ``h`` heads, in the kernel's order (its
    ``item_of``): the query tile is the slowest index, from the last one,
    so that under the causal mask the heaviest items come first; then the
    sequence, then the head."""
    n_q = -(-sq // ROWS)
    bh = b * h
    return [((n_q - 1 - w // bh) * ROWS, (w % bh) // h, w % h)
            for w in range(n_q * bh)]


def item_tiles(q0: int, sk: int, causal: bool) -> int:
    """The K/V tiles a block loads for the item at rows q0..: all of Sk's,
    or, causal, those at or left of its last row (the kernel's
    ``item_tiles``)."""
    n = -(-sk // KEYS)
    return min(n, (q0 + ROWS - 1) // KEYS + 1) if causal else n


def persistent_plan(b: int, sq: int, h: int, sms: int):
    """(blocks, walks): the grid of ``min(items, sms)`` blocks and, for
    each block, the items it takes in order: blockIdx.x, + blocks, ..."""
    items = work_items(b, sq, h)
    blocks = min(len(items), sms)
    return blocks, [items[i::blocks] for i in range(blocks)]


def _smem_for(dh: int, stages: int) -> int:
    return (1024 + (2 * ROWS + 2 * stages * KEYS) * dh * BF16_BYTES
            + (3 * stages + 2) * 8)


def ring_stages(dh: int) -> int:
    """The K/V ring's stages at head size ``dh``: as many as fit in a
    block's shared memory, at most MAX_STAGES (the kernel's
    ``ring_stages``)."""
    n = MAX_STAGES
    while _smem_for(dh, n) > SMEM_MAX:
        n -= 1
    return n


def fwd_smem_bytes(dh: int) -> int:
    """The bf16 forward's dynamic shared memory a block at head size
    ``dh``: 1,024 bytes of alignment slack, Q and O's staging rows (128
    each), ``ring_stages(dh)`` K and V tiles of 64 keys, and the mbarriers
    (K full, V full and empty a stage, Q full, Q empty)."""
    return _smem_for(dh, ring_stages(dh))


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
