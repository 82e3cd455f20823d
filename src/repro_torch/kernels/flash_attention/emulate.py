"""The bf16 flash-attention kernels' arithmetic, forward and backward,
step for step, in plain PyTorch.

``ref.attention_ref`` is the function K2 computes; this is how its bf16
body computes it: fp32 scores of bf16 q and k, an online softmax over
64-key tiles in the log2 domain (the scale folded into the exponent, one
rounding for the multiply-add), mask -1e30, P rounded to bf16 before
``P V``, fp32 accumulation, and ``acc * (1 / max(l, 1e-30))`` rounded to
bf16 at the end.  The tests hold the JAX flash kernel to it on the CPU and
hold the kernel to it on the card at about one bf16 ulp, so the two
comparisons together tie the kernel's rounding points to the reference.
``attention_bwd_bf16_emulated`` does the same for the backward kernels.
"""
import torch

BLOCK_K = 64  # keys per K/V tile of the bf16 kernel
NEG_INF = -1e30
LOG2E = 1.4426950408889634


def attention_bf16_emulated(q, k, v, causal: bool = True,
                            scale: float | None = None):
    """q: (B, S, H, Dh); k/v: (B, Sk, KV, Dh), bf16 -> (B, S, H, Dh) bf16;
    with ``causal``, row i attends to keys 0..i whatever Sk is."""
    b, s, h, dh = q.shape
    sk = k.shape[1]
    group = h // k.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    f32 = torch.float32
    scale2 = (torch.tensor(scale, dtype=f32) * torch.tensor(LOG2E, dtype=f32))
    scale2 = scale2.double().item()  # the kernel's fp32 product, exactly
    qf = q.transpose(1, 2).float()                          # (B, H, S, Dh)
    kf = k.transpose(1, 2).float().repeat_interleave(group, 1)
    vf = v.transpose(1, 2).float().repeat_interleave(group, 1)
    rows = torch.arange(s, device=q.device)[:, None]
    m = torch.full((b, h, s, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, s, 1), device=q.device)
    acc = torch.zeros((b, h, s, dh), device=q.device)
    for k0 in range(0, sk, BLOCK_K):
        cols = torch.arange(k0, min(k0 + BLOCK_K, sk), device=q.device)[None]
        sc = qf @ kf[:, :, k0:k0 + BLOCK_K].transpose(-1, -2)
        if causal:
            sc = torch.where(cols <= rows, sc,
                             torch.tensor(NEG_INF, device=q.device))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True) * scale2)
        alpha = torch.exp2(m - m_new)
        # fma(score, scale2, -m_new): the product is exact in float64
        p = torch.exp2((sc.double() * scale2 - m_new.double()).to(f32))
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + p.to(torch.bfloat16).float() @ \
            vf[:, :, k0:k0 + BLOCK_K]
        m = m_new
    out = acc * (1.0 / torch.clamp(l, min=1e-30))
    return out.to(torch.bfloat16).transpose(1, 2)


def attention_bwd_bf16_emulated(q, k, v, out, lse, dout, causal: bool = True,
                                scale: float | None = None):
    """The gradients (dq, dk, dv) as K2's bf16 backward computes them: q,
    out, dout (B, S, H, Dh) and k, v (B, Sk, KV, Dh) bf16, lse the
    forward's (B, H, S) float32 log-sum-exp -> bf16 in the inputs' shapes.

    D = rowsum(dO O) in fp32; fp32 scores S = Q K^T and dP = dO V^T of the
    bf16 values; P = exp2(S scale log2e - lse log2e), the scale and lse
    folded into one multiply-add rounded once; masked pairs (top-left
    causal, whatever Sk is) P = 0; dS = P (dP - D); P and dS rounded to
    bf16 before dV = P^T dO, dK = dS^T Q and dQ = dS K, accumulated in
    fp32, dK and dV over each KV head's query heads; dK and dQ times the
    scale in fp32, then one rounding to bf16."""
    b, s, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    group = h // kv
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    f32, bf16 = torch.float32, torch.bfloat16
    log2e = torch.tensor(LOG2E, dtype=f32)
    scale2 = (torch.tensor(scale, dtype=f32) * log2e).double().item()
    qf, of, dof = (t.transpose(1, 2).float() for t in (q, out, dout))
    kf = k.transpose(1, 2).float().repeat_interleave(group, 1)
    vf = v.transpose(1, 2).float().repeat_interleave(group, 1)
    lse2 = (lse.float() * log2e)[..., None]                 # (B, H, S, 1)
    delta = (dof * of).sum(-1, keepdim=True)
    sc = qf @ kf.transpose(-1, -2)                          # (B, H, S, Sk)
    # fma(score, scale2, -lse2): the product is exact in float64
    p = torch.exp2((sc.double() * scale2 - lse2.double()).to(f32))
    if causal:
        keep = (torch.arange(s, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        p = torch.where(keep, p, torch.zeros((), dtype=f32, device=q.device))
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    p16, ds16 = p.to(bf16).float(), ds.to(bf16).float()
    dq = (ds16 @ kf) * torch.tensor(scale, dtype=f32)
    dk = (ds16.transpose(-1, -2) @ qf).reshape(b, kv, group, sk, dh).sum(2)
    dv = (p16.transpose(-1, -2) @ dof).reshape(b, kv, group, sk, dh).sum(2)
    dk = dk * torch.tensor(scale, dtype=f32)
    return (dq.to(bf16).transpose(1, 2), dk.to(bf16).transpose(1, 2),
            dv.to(bf16).transpose(1, 2))
