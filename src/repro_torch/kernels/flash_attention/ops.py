"""Public flash-attention (prefill) wrapper: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

Model code passes (B, S, H, Dh) activations and (B, Sk, KV, Dh) keys and
values, Sk its own (an encoder's length in cross attention).  The kernel
reads that layout through strides; only the plain version works
head-major.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import flash_attention_bshd
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, causal: bool = True,
                    scale: float | None = None):
    """q: (B, S, H, Dh); k/v: (B, Sk, KV, Dh) -> (B, S, H, Dh), any Sk >= 1.
    ``causal`` masks as the TPU kernel does, from the top left: query row
    i attends to keys 0..i, whatever Sk is.

    On CUDA tensors it launches the kernel or raises;
    ``flash_attention.launches`` counts the launches."""
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, Dh), got {tuple(q.shape)}")
    b, s, h, dh = q.shape
    sk, kv = k.shape[1:3] if k.dim() == 4 else (0, 0)
    if (k.shape != (b, sk, kv, dh) or v.shape != k.shape or kv == 0
            or sk == 0 or h % kv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, S|Sk, H|KV, Dh) "
                         f"with Sk >= 1 and H a multiple of KV")
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        out = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale)
        return out.transpose(1, 2)
    if not q.is_cuda:
        raise ValueError(f"flash_attention: q on {q.device}")
    if dh not in _build.HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {dh} not in "
                         f"{_build.HEAD_DIMS}")
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _build.check_strided(name, t, q.device)
    if b * s:
        flash_attention_bshd(q, k, v, out, causal, float(scale))
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
