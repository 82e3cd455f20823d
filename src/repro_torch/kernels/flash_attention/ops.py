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

Each launch is an op of the ``repro_torch`` namespace (``_library``):
``flash_attention`` (with or without the rows' log-sum-exp) and
``flash_attention_bwd``, whose shape-only forms let a step be traced on
meta tensors, and whose FLOP formulas are ``flash_attention_flops`` and
``flash_attention_bwd_flops``.
"""
from __future__ import annotations

import torch

from repro_torch.distributed.local import is_sharded, on_heads
from repro_torch.kernels import _build, _library
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


# products of a kept (row, key) pair in K2's backward: S = Q K^T and dP =
# dO V^T in each of its two kernels, dV, dK and dQ (csrc's header); the
# gradient needs five (S and dP once)
BWD_PRODUCTS = 7
BWD_PRODUCTS_NEEDED = 5


def causal_pairs(s: int, sk: int) -> int:
    """(query row, key) pairs the top-left causal mask keeps: row i sees
    keys 0..min(i, Sk - 1)."""
    if sk >= s:
        return s * (s + 1) // 2
    return sk * (sk + 1) // 2 + (s - sk) * sk


def flash_attention_flops(b: int, s: int, sk: int, h: int, dh: int,
                          causal: bool) -> int:
    """K2's forward tensor-core FLOPs: Q K^T and P V over the kept (row,
    key) pairs, 2 Dh each, for every one of the B x H query heads."""
    pairs = causal_pairs(s, sk) if causal else s * sk
    return 4 * b * h * dh * pairs


def flash_attention_bwd_flops(b: int, s: int, sk: int, h: int, dh: int,
                              causal: bool,
                              products: int = BWD_PRODUCTS) -> int:
    """K2's backward tensor-core FLOPs: ``products`` products of 2 Dh over
    the kept pairs (the kernel runs ``BWD_PRODUCTS``; the gradient needs
    ``BWD_PRODUCTS_NEEDED``)."""
    pairs = causal_pairs(s, sk) if causal else s * sk
    return 2 * products * b * h * dh * pairs


def _forward_cuda(q, k, v, causal, scale, with_lse):
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


def _fwd_cuda(q, k, v, causal, scale):
    return _forward_cuda(q, k, v, causal, scale, False)[0]


def _fwd_lse_cuda(q, k, v, causal, scale):
    return _forward_cuda(q, k, v, causal, scale, True)


def _fwd_fake(q, k, v, causal, scale):
    _check_shapes(q, k, v)
    return q.new_empty(q.shape)


def _fwd_lse_fake(q, k, v, causal, scale):
    _check_shapes(q, k, v)
    b, s, h, _ = q.shape
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


def _fwd_flops(q, k, v, causal, scale, out_shape):
    b, s, h, dh = q
    return flash_attention_flops(b, s, k[1], h, dh, causal)


def _check_bwd(q, k, v, out, dout):
    _check_shapes(q, k, v)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must be q's {tuple(q.shape)}")


def _bwd_cuda(q, k, v, out, lse, dout, causal, scale):
    b, s, h, _ = q.shape
    if dout.stride(-1) != 1 or any(x * dout.element_size() % 16
                                   for x in dout.stride()[:-1]):
        dout = dout.contiguous()
    if lse.shape != (b, h, s) or lse.dtype != torch.float32 or \
            not lse.is_contiguous():
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


def _bwd_fake(q, k, v, out, lse, dout, causal, scale):
    _check_bwd(q, k, v, out, dout)
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _bwd_flops(q, k, v, out, lse, dout, causal, scale, out_shape):
    b, s, h, dh = q
    return flash_attention_bwd_flops(b, s, k[1], h, dh, causal)


_FWD = _library.define(
    "flash_attention(Tensor q, Tensor k, Tensor v, bool causal, "
    "float scale) -> Tensor", _fwd_cuda, _fwd_fake, _fwd_flops)
_FWD_LSE = _library.define(
    "flash_attention_lse(Tensor q, Tensor k, Tensor v, bool causal, "
    "float scale) -> (Tensor, Tensor)", _fwd_lse_cuda, _fwd_lse_fake,
    _fwd_flops)
_BWD = _library.define(
    "flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor lse, Tensor dout, bool causal, float scale) "
    "-> (Tensor, Tensor, Tensor)", _bwd_cuda, _bwd_fake, _bwd_flops)


def _forward(q, k, v, causal, scale, with_lse):
    """(out, lse or None)."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        res = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, scale=scale,
                            return_lse=with_lse)
        out, lse = res if with_lse else (res, None)
        return out.transpose(1, 2), lse
    if with_lse:
        return _FWD_LSE(q, k, v, causal, float(scale))
    return _FWD(q, k, v, causal, float(scale)), None


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
    ``flash_attention.launches`` counts the launches.  On DTensors it runs
    on each rank's batch rows and heads, the sequence gathered
    (``distributed.local.on_heads``)."""
    _check_shapes(q, k, v)
    if is_sharded(q, k, v):
        return on_heads(flash_attention, q, k, v, causal=causal,
                        scale=scale)
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
    _check_bwd(q, k, v, out, dout)
    scale = scale if scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if all(t.device.type == "cpu" for t in (q, k, v, out, dout)):
        dq, dk, dv = attention_bwd_ref(
            *(t.transpose(1, 2) for t in (q, k, v, out, dout)),
            causal=causal, scale=scale)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    if lse is None:
        raise ValueError("flash_attention_bwd: lse must be the forward's "
                         "contiguous (B, H, S) float32 log-sum-exp")
    return _BWD(q, k, v, out, lse, dout, causal, float(scale))


flash_attention.launches = 0
flash_attention_bwd.launches = 0
