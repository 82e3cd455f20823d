"""Public decode-attention wrapper: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

The cache stays in the model's (B, T, KV, Dh) layout: the kernel reads it in
place through strides; only the plain version works head-major.

The launch is the op ``repro_torch::decode_attention`` (``_library``),
whose shape-only form lets a step be traced on meta tensors, and whose
FLOP formula is ``decode_attention_flops``.
"""
from __future__ import annotations

import operator

import torch

from repro_torch.distributed.local import is_sharded, on_heads
from repro_torch.kernels import _build, _library
from repro_torch.kernels.decode_attention.kernel import (cluster_size,
                                                        decode_attention_bhd,
                                                        sm_count)
from repro_torch.kernels.decode_attention.ref import decode_attention_ref


def decode_attention_flops(b: int, h: int, dh: int, keys: int) -> int:
    """K3's FLOPs for one query row of each of the B x H heads against
    ``keys`` cache positions (pos + 1): q K^T and P V, 2 Dh a key each."""
    return 4 * b * h * dh * keys


def _decode_cuda(q, k, v, pos, scale):
    if not q.is_cuda:
        raise ValueError(f"decode_attention: q on {q.device}")
    b, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"decode_attention: head size {dh} not in "
                         f"{_build.HEAD_DIMS}")
    out = torch.empty((b, h, dh), dtype=q.dtype, device=q.device)
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        _build.check_strided(name, x, q.device)
    if b:
        decode_attention_bhd(q, k, v, out, pos,
                             cluster_size(b, kv, h // kv,
                                          t, sm_count(q.device.index)),
                             scale)
        decode_attention.launches += 1
    return out


def _decode_fake(q, k, v, pos, scale):
    return q.new_empty(q.shape)


def _decode_flops(q, k, v, pos, scale, out_shape):
    """The op's position lives on the device, where the counter does not
    read it (that would wait for the card, and a trace has no value): it
    counts the whole cache of T slots, which is pos + 1 at the cache's last
    position, where the decode cells read."""
    b, h, dh = q
    return decode_attention_flops(b, h, dh, k[1])


_DECODE = _library.define(
    "decode_attention(Tensor q, Tensor k, Tensor v, Tensor pos, "
    "float scale) -> Tensor", _decode_cuda, _decode_fake, _decode_flops)


def decode_attention(q, k, v, pos, scale: float | None = None):
    """q: (B, H, Dh); k/v: (B, T, KV, Dh); pos: an int, or a one-element
    int64 tensor on q's device — returns (B, H, Dh), attending to cache
    positions <= pos.

    On CUDA tensors it launches the kernel or raises.  The kernel reads
    the position from device memory, and its launch depends only on the
    shapes, so a launch captured in a CUDA graph follows the position it
    finds at each replay; a position past the cache is clamped to its end
    there (an int is checked here).  The positions are cut into the splits
    of ``kernel.split_plan``, which run as one cluster of blocks and merge
    in its shared memory.  ``decode_attention.launches`` counts calls.  On
    DTensors it runs on each rank's batch rows and KV heads, T gathered
    (``distributed.local.on_heads``)."""
    if is_sharded(q, k, v):
        return on_heads(decode_attention, q, k, v, pos, scale=scale)
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"expected q (B, H, Dh), k/v (B, T, KV, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    b, h, dh = q.shape
    t, kv = k.shape[1], k.shape[2]
    if k.shape != (b, t, kv, dh) or v.shape != k.shape or h % kv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} do not match")
    if isinstance(pos, torch.Tensor):
        if (pos.shape != (1,) or pos.dtype != torch.int64
                or pos.device != q.device):
            raise ValueError(f"pos must be a one-element int64 tensor on "
                             f"{q.device}; got {pos.dtype} "
                             f"{tuple(pos.shape)} on {pos.device}")
        host = int(pos) if pos.device.type == "cpu" else None
    else:
        host = operator.index(pos)
    if host is not None and not 0 <= host < t:
        raise ValueError(f"pos {host} outside the cache of length {t}")
    g = h // kv
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    if all(x.device.type == "cpu" for x in (q, k, v)):
        out = decode_attention_ref(q.reshape(b, kv, g, dh), k.transpose(1, 2),
                                   v.transpose(1, 2), pos, scale=scale)
        return out.reshape(b, h, dh)
    if host is not None:
        pos = torch.full((1,), host, dtype=torch.int64, device=q.device)
    return _DECODE(q, k, v, pos, float(scale))


decode_attention.launches = 0
