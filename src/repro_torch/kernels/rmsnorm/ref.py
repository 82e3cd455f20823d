"""Plain PyTorch versions of the RMSNorm kernel's two entries."""
import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def add_rmsnorm_ref(x, r, scale, eps: float = 1e-5):
    """(s, y): the residual sum ``x + r`` in x's dtype and its RMSNorm."""
    s = x + r
    return s, rmsnorm_ref(s, scale, eps)
