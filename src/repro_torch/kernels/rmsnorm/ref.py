"""Plain PyTorch versions of the RMSNorm kernel's entries: the two
forwards and their backward, written out (not autograd)."""
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


def _bwd_f32(x, scale, dy, eps):
    """(dx, dscale) of the norm at input x in fp32, dx not yet rounded."""
    d = x.shape[-1]
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    xhat = xf * rstd
    g = dy.float() * scale.float()
    dx = rstd * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    return dx, (dy.float() * xhat).reshape(-1, d).sum(0)


def rmsnorm_bwd_ref(x, scale, dy, eps: float = 1e-5):
    """The gradients of ``y = rmsnorm(x, scale)`` given dy: with
    ``rstd = rsqrt(mean(x^2) + eps)``, ``x_hat = x * rstd`` and ``g = dy *
    scale``, ``dx = rstd * (g - x_hat * mean(g * x_hat))`` in x's dtype and
    ``dscale = sum over rows of dy * x_hat`` in float32; all in fp32."""
    dx, dscale = _bwd_f32(x, scale, dy, eps)
    return dx.to(x.dtype), dscale


def add_rmsnorm_bwd_ref(s, scale, dy, ds, eps: float = 1e-5):
    """The gradients of ``(s, y) = add_rmsnorm(x, r, scale)`` given dy and
    ds (the gradient reaching ``s`` through the residual stream): the
    norm's ``dx`` at the stored ``s`` plus ``ds``, rounded once to s's
    dtype, which is both x's and r's gradient; and ``dscale``."""
    dx, dscale = _bwd_f32(s, scale, dy, eps)
    return (dx + ds.float()).to(s.dtype), dscale
