"""Public RMSNorm wrappers: the CUDA kernel for CUDA tensors, the plain
versions for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows
from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref


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


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim of an arbitrarily-shaped ``x``.

    On CUDA tensors it launches the kernel or raises; ``rmsnorm.launches``
    counts the launches."""
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


def add_rmsnorm(x, r, scale, eps: float = 1e-5):
    """The residual add and the RMSNorm after it, in one pass: returns
    ``(s, y)`` with ``s = x + r`` rounded once to x's dtype (the bits of
    ``torch.add``) and ``y = rmsnorm(s, scale, eps)``, computed from the
    rounded ``s``.  ``s`` is a new tensor; ``x`` and ``r`` are not written.

    On CUDA tensors it launches the kernel or raises;
    ``add_rmsnorm.launches`` counts the launches."""
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


rmsnorm.launches = 0
add_rmsnorm.launches = 0
