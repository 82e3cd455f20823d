"""The bf16 flash-attention kernel's arithmetic, step for step, in plain
PyTorch.

``ref.attention_ref`` is the function K2 computes; this is how its bf16
body computes it: fp32 scores of bf16 q and k, an online softmax over
64-key tiles in the log2 domain (the scale folded into the exponent, one
rounding for the multiply-add), mask -1e30, P rounded to bf16 before
``P V``, fp32 accumulation, and ``acc * (1 / max(l, 1e-30))`` rounded to
bf16 at the end.  The tests hold the JAX flash kernel to it on the CPU and
hold the kernel to it on the card at about one bf16 ulp, so the two
comparisons together tie the kernel's rounding points to the reference.
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
