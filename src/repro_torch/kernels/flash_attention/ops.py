"""Public flash-attention (prefill) wrapper: the CUDA kernel for CUDA
tensors, the plain version for CPU tensors.

Model code passes (B, S, H, Dh) activations and (B, Sk, KV, Dh) keys and
values, Sk its own (an encoder's length in cross attention).  The kernels
read that layout through strides; only the plain versions work
head-major.  Where a gradient is wanted (grad mode on and an input that
requires it) the call is a ``torch.autograd.Function``: its forward also
keeps each row's log-sum-exp, and its backward is
``flash_attention_bwd``, a kernel too.  Otherwise (serving) the forward
runs alone and keeps nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bshd, flash_attention_bwd_bshd)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)


def _check_shapes(q, k, v):
    if q.dim() != 4:
        raise ValueError(f"q must be (B, S, H, Dh), got {tuple(q.shape)}")
    b, s, h, dh = q.shape
    sk, kv = k.shape[1:3] if k.dim() == 4 else (0, 0)
    if (k.shape != (b, sk, kv, dh) or v.shape != k.shape or kv == 0
            or sk == 0 or h % kv):
        raise ValueError(f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, S|Sk, H|KV, Dh) "
                         f"with Sk >= 1 and H a multiple of KV")


def _on_card(q, tensors, what):
    """Raises unless the kernels take ``tensors`` on q's card."""
    if not q.is_cuda:
        raise ValueError(f"{what}: q on {q.device}")
    if q.shape[-1] not in _build.HEAD_DIMS:
        raise ValueError(f"{what}: head size {q.shape[-1]} not in "
                         f"{_build.HEAD_DIMS}")
    for name, t in tensors:
        _build.check_strided(name, t, q.device)


def _forward(q, k, v, causal, scale, with_lse):
    """(out, lse or None)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        res = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale,
                            return_lse=with_lse)
        out, lse = res if with_lse else (res, None)
        return out.transpose(1, 2), lse
    b, s, h, dh = q.shape
    out = torch.empty((b, s, h, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    _on_card(q, (("q", q), ("k", k), ("v", v), ("out", out)),
             "flash_attention")
    if b * s:
        flash_attention_bshd(q, k, v, out, causal, float(scale), lse)
        flash_attention.launches += 1
    return out, lse


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _forward(q, k, v, causal, scale, True)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = True,
                    scale: float | None = None):
    """q: (B, S, H, Dh); k/v: (B, Sk, KV, Dh) -> (B, S, H, Dh), any Sk >= 1.
    ``causal`` masks as the TPU kernel does, from the top left: query row
    i attends to keys 0..i, whatever Sk is.

    On CUDA tensors it launches the kernel or raises;
    ``flash_attention.launches`` counts the launches."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, scale)
    return _forward(q, k, v, causal, scale, False)[0]


def flash_attention_lse(q, k, v, causal: bool = True,
                        scale: float | None = None):
    """``flash_attention`` without autograd, returning ``(out, lse)``: lse
    (B, H, S) float32 is each query row's log-sum-exp of its scaled,
    masked scores, which the backward reads.  Counts as a
    ``flash_attention`` launch."""
    _check_shapes(q, k, v)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    return _forward(q, k, v, causal, scale, True)


def flash_attention_bwd(q, k, v, out, lse, dout, causal: bool = True,
                        scale: float | None = None):
    """The gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` given its
    output ``out``, the rows' log-sum-exp ``lse`` (B, H, S) float32 that
    the forward kept (the plain version recomputes it) and the output's
    gradient ``dout``; each in its input's dtype and shape.  dK and dV sum
    each KV head's query heads in a fixed order: two runs give the same
    bits.

    On CUDA tensors it launches the kernels (three a call: D = rowsum(dO
    O), dK/dV, dQ) or raises; ``flash_attention_bwd.launches`` counts the
    calls.  With no query row (S = 0) it launches nothing and returns zero
    dk and dv, as the plain version does."""
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if all(t.device.type == "cpu" for t in (q, k, v, out, dout)):
        dq, dk, dv = attention_bwd_ref(
            *(t.transpose(1, 2) for t in (q, k, v, out, dout)),
            causal=causal, scale=scale)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    b, s, h, _ = q.shape
    if dout.stride(-1) != 1 or any(x * dout.element_size() % 16
                                   for x in dout.stride()[:-1]):
        dout = dout.contiguous()
    if lse is None or lse.shape != (b, h, s) or \
            lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse must be the forward's "
                         "contiguous (B, H, S) float32 log-sum-exp")
    # with no query row there is nothing to launch, and dK and dV are 0
    alloc = torch.empty if b * s else torch.zeros
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = alloc(k.shape, dtype=k.dtype, device=q.device)
    dv = alloc(v.shape, dtype=v.dtype, device=q.device)
    _on_card(q, (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
                 ("dq", dq), ("dk", dk), ("dv", dv)), "flash_attention_bwd")
    if lse.device != q.device:
        raise ValueError(f"lse is on {lse.device}, expected {q.device}")
    if b * s:
        flash_attention_bwd_bshd(q, k, v, out, dout, lse, dq, dk, dv,
                                 causal, float(scale))
        flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
