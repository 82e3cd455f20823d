"""Plain PyTorch version of the fused RMSNorm kernel."""
import torch


def rmsnorm_ref(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)
