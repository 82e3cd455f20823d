"""Public RMSNorm wrapper: the Triton kernel for CUDA tensors, the plain
version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm.kernel import rmsnorm_rows
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

_DTYPES = (torch.float32, torch.bfloat16)


def rmsnorm(x, scale, eps: float = 1e-5):
    """RMSNorm over the last dim of an arbitrarily-shaped ``x``.

    On CUDA tensors it launches the kernel or raises; ``rmsnorm.launches``
    counts the launches."""
    d = x.shape[-1]
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if not (x.is_cuda and scale.device == x.device):
        raise ValueError(f"rmsnorm: x on {x.device}, scale on {scale.device}")
    if x.dtype not in _DTYPES or scale.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: unsupported dtypes {x.dtype}, {scale.dtype}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: x and scale must be contiguous")
    out = torch.empty_like(x)
    if x.numel():
        rmsnorm_rows(x.view(-1, d), scale, out.view(-1, d), eps)
        rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
