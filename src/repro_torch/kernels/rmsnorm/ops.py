"""Public RMSNorm wrappers: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors.

Where a gradient is wanted (grad mode on and an input that requires it),
``rmsnorm`` and ``add_rmsnorm`` run as ``torch.autograd.Function``s whose
backward is ``rmsnorm_bwd``, a kernel too; otherwise (serving, under
``inference_mode``) they launch the forward alone and save nothing."""
from __future__ import annotations

import torch

from repro_torch.distributed.local import is_sharded, on_rows
from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_rows, rmsnorm_rows
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                             add_rmsnorm_ref, rmsnorm_bwd_ref,
                                             rmsnorm_ref)


def _check(x, r, scale):
    """Raises unless scale is (d,) for x's last dim d, r (if given) has x's
    shape, and all lie contiguous on one card, scale in float32 or
    bfloat16 (the kernel checks that x and r share a dtype it takes)."""
    if scale.shape != x.shape[-1:] or (r is not None and r.shape != x.shape):
        raise ValueError(f"shapes x {tuple(x.shape)}, scale "
                         f"{tuple(scale.shape)}"
                         + ("" if r is None else f", r {tuple(r.shape)}"))
    if not (x.is_cuda and scale.device == x.device
            and (r is None or r.device == x.device)):
        raise ValueError(f"rmsnorm: tensors must share one card; x on "
                         f"{x.device}, scale on {scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()
            and (r is None or r.is_contiguous())):
        raise ValueError("rmsnorm: inputs must be contiguous")
    if scale.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"rmsnorm: scale must be float32 or bfloat16, got "
                        f"{scale.dtype}")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _rmsnorm_fwd(x, scale, eps):
    if x.device.type == "cpu" and scale.device.type == "cpu":
        if scale.shape != x.shape[-1:]:
            raise ValueError(f"scale shape {tuple(scale.shape)} != "
                             f"({x.shape[-1]},)")
        return rmsnorm_ref(x, scale, eps)
    _check(x, None, scale)
    y = torch.empty_like(x)
    if x.numel():
        rmsnorm_rows(x, None, scale, None, y, eps)
        rmsnorm.launches += 1
    return y


def _add_rmsnorm_fwd(x, r, scale, eps):
    if all(t.device.type == "cpu" for t in (x, r, scale)):
        if r.shape != x.shape or scale.shape != x.shape[-1:]:
            raise ValueError(f"shapes x {tuple(x.shape)}, r "
                             f"{tuple(r.shape)}, scale {tuple(scale.shape)}")
        return add_rmsnorm_ref(x, r, scale, eps)
    _check(x, r, scale)
    s, y = torch.empty_like(x), torch.empty_like(x)
    if x.numel():
        rmsnorm_rows(x, r, scale, s, y, eps)
        add_rmsnorm.launches += 1
    return s, y


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, eps=ctx.eps)
        return dx, dscale.to(scale.dtype), None


class _AddRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, r, scale, eps):
        s, y = _add_rmsnorm_fwd(x, r, scale, eps)
        ctx.eps = eps
        ctx.set_materialize_grads(False)  # s's gradient is None after the
        # last block, whose sum only the final norm reads
        ctx.save_for_backward(s, scale)
        return s, y

    @staticmethod
    def backward(ctx, ds, dy):
        s, scale = ctx.saved_tensors
        if dy is None:
            return ds, ds, None, None
        dx, dscale = rmsnorm_bwd(s, scale, dy, ds, eps=ctx.eps)
        return dx, dx, dscale.to(scale.dtype), None


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim of an arbitrarily-shaped ``x``.

    On CUDA tensors it launches the kernel or raises; ``rmsnorm.launches``
    counts the launches.  On a DTensor it runs on each rank's rows, the
    last dim gathered (``distributed.local.on_rows``)."""
    if is_sharded(x):
        return on_rows(rmsnorm, (x,), scale, eps)
    if _wants_grad(x, scale):
        return _RMSNorm.apply(x, scale, eps)
    return _rmsnorm_fwd(x, scale, eps)


def add_rmsnorm(x, r, scale, eps: float = 1e-5):
    """The residual add and the RMSNorm after it, in one pass: returns
    ``(s, y)`` with ``s = x + r`` rounded once to x's dtype (the bits of
    ``torch.add``) and ``y = rmsnorm(s, scale, eps)``, computed from the
    rounded ``s``.  ``s`` is a new tensor; ``x`` and ``r`` are not written.

    On CUDA tensors it launches the kernel or raises;
    ``add_rmsnorm.launches`` counts the launches.  On DTensors it runs on
    each rank's rows, as ``rmsnorm``."""
    if is_sharded(x, r):
        return on_rows(add_rmsnorm, (x, r), scale, eps)
    if _wants_grad(x, r, scale):
        return _AddRMSNorm.apply(x, r, scale, eps)
    return _add_rmsnorm_fwd(x, r, scale, eps)


def rmsnorm_bwd(x, scale, dy, ds=None, eps: float = 1e-5):
    """The backward of ``rmsnorm`` at input ``x`` given ``dy``, or, with
    ``ds``, of ``add_rmsnorm`` at the stored sum ``x = s``: returns (dx,
    dscale), dx in x's dtype (with ``ds`` it is both x's and r's
    gradient), dscale in float32, summed over the rows in a fixed order
    (no float atomics: two runs give the same bits).

    On CUDA tensors it launches the kernel or raises;
    ``rmsnorm_bwd.launches`` counts the launches."""
    if all(t.device.type == "cpu" for t in (x, scale, dy)) and (
            ds is None or ds.device.type == "cpu"):
        if dy.shape != x.shape or scale.shape != x.shape[-1:] or (
                ds is not None and ds.shape != x.shape):
            raise ValueError(f"shapes x {tuple(x.shape)}, dy "
                             f"{tuple(dy.shape)}, scale {tuple(scale.shape)}")
        if ds is None:
            return rmsnorm_bwd_ref(x, scale, dy, eps)
        return add_rmsnorm_bwd_ref(x, scale, dy, ds, eps)
    dy = dy.contiguous()
    ds = None if ds is None else ds.contiguous()
    _check(x, dy, scale)
    if ds is not None:
        _check(x, ds, scale)
    dx = torch.empty_like(x)
    dscale = torch.zeros(x.shape[-1], dtype=torch.float32, device=x.device)
    if x.numel():
        rmsnorm_bwd_rows(x, scale, dy, ds, dx, dscale, eps)
        rmsnorm_bwd.launches += 1
    return dx, dscale


rmsnorm.launches = 0
add_rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
