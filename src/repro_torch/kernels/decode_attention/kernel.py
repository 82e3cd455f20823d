"""ctypes binding of the CUDA decode-attention kernel, and the choice of
how many splits of the cache it runs side by side.  The kernel reads the
position from device memory, so the launch depends on the cache's length
and never on the position.

The kernel is ``csrc/decode_attention.cu`` (its header comment says what it
replaces and what bounds it); it is compiled at the first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

TILE = 64           # positions: every split is a whole number of tiles
WARPS = 8           # warps a block (csrc NW)
CHUNK = 8           # positions a warp takes at a time (csrc CH)
HEADS_A_BLOCK = 8   # query heads one block takes at most (csrc GMAX)
MAX_SPLIT = 8       # splits of one (b, kv head): one cluster (csrc MAX_SPLIT)


def split_plan(b: int, kv: int, g: int, pos: int, sms: int):
    """(n_split, split_rows): how the kernel cuts positions 0..pos for a
    batch of ``b`` sequences, ``kv`` KV heads of ``g`` query heads each, on
    a card with ``sms`` SMs: ``splits_of(pos, split_count(...))``, which
    the kernel computes itself from the position in device memory."""
    return splits_of(pos, split_count(b, kv, g, sms))


def split_count(b: int, kv: int, g: int, sms: int) -> int:
    """The most splits of one (b, kv head) the kernel runs side by side.

    The B * KV (* head chunks) blocks of eight warps are multiplied by
    splits while they stay within one for every two SMs, up to MAX_SPLIT:
    that many already draw what the card's memory gives this access
    pattern, and a split costs its merge.  It does not depend on the
    position."""
    blocks = b * kv * -(-g // HEADS_A_BLOCK)
    return max(1, min(MAX_SPLIT, sms // (2 * blocks)))


def cluster_size(b: int, kv: int, g: int, t: int, sms: int) -> int:
    """The grid's splits (its z, one cluster) for a cache of ``t`` slots:
    ``split_count`` capped at the cache's tiles, the most ``splits_of``
    gives at any pos < t.  Fixed for a cache, so one launch serves every
    position; a block past the splits of its launch's pos computes
    nothing."""
    return min(split_count(b, kv, g, sms), -(-t // TILE))


def splits_of(pos: int, n_split: int):
    """(n_split, split_rows) of positions 0..pos cut into at most
    ``n_split`` splits of equal whole tiles, none past pos."""
    n_tiles = pos // TILE + 1
    per = -(-n_tiles // min(n_split, n_tiles))
    return -(-n_tiles // per), per * TILE


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry():
    lib = _build.load("decode_attention")
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_int64] * 10 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def decode_attention_bhd(q, k, v, out, pos_t, n_split: int,
                         scale: float) -> None:
    """q/out: (B, H, Dh); k/v: (B, T, KV, Dh); pos_t: a one-element int64
    tensor on the card, read by the kernel; checked by the caller.  The
    grid runs ``n_split`` splits (at most 8, at most T's tiles); the kernel
    cuts 0..pos into ``splits_of(pos, n_split)``."""
    lib, fn = _entry()
    b, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    strides = (*q.stride()[:2], *k.stride()[:3], *v.stride()[:3],
               *out.stride()[:2])
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              pos_t.data_ptr(), _build.dtype_code(q, k, v, out), b, kv,
              h // kv, dh, t, n_split, *strides, scale,
              torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "decode_attention")
