"""The split decode-attention kernel's arithmetic, step for step, in plain
PyTorch.

``ref.decode_attention_ref`` is the function K3 computes; this is how the
kernel computes it.  Positions 0..pos are cut into the splits of
``kernel_splits`` (whole 64-position tiles), which is how the kernel plans
them from the position it reads in device memory.  In a split, warp w takes
the chunks of 8 positions w, w + 8, ... in order and keeps its own fp32
(m, l, acc) in the log2 domain, rescaled when m moves; the warps merge in
warp order and the splits in split order, with weights 2^(m_i - M), and the
output is ``acc / max(l, 1e-30)`` in q's dtype.  fp32 folds scale * log2(e)
into q.  bf16 (the tensor-core body) takes fp32 scores of bf16 q and k,
folds the scale into the exponent's FMA, and rounds P to bf16 for ``P V``,
with l summed from the unrounded P.  The tests hold the JAX kernel to it on
the CPU and hold the kernel to it on the card, at the kernel's n_split,
within 1e-6 in fp32 and one bf16 ulp.  Only tests and ``chip_smoke.py`` use
it.
"""
import torch

from repro_torch.kernels.decode_attention.kernel import CHUNK, TILE, WARPS

LOG2E = 1.4426950408889634
NEG_INF = -1e30


def kernel_splits(pos: int, n_split: int, t: int):
    """(live splits, split_rows) as the kernel computes them, in its
    integer arithmetic, for the position ``pos`` it reads, a grid of
    ``n_split`` splits and a cache of ``t`` slots: the position clamped to
    the cache, whole tiles a split, none past pos.  Equal to
    ``kernel.splits_of(pos, n_split)`` for 0 <= pos < t."""
    pos = min(max(pos, -1), t - 1)
    n_tiles = max(pos, 0) // TILE + 1
    m = min(n_split, n_tiles)
    per = (n_tiles + m - 1) // m
    return (n_tiles + per - 1) // per, per * TILE


def _merge(parts):
    """(m, l, acc) of parts merged in their order with weights 2^(m_i - M)."""
    big_m = torch.stack([m for m, _, _ in parts]).amax(0)
    l, acc = 0.0, 0.0
    for m, l_i, acc_i in parts:
        w = torch.exp2(m - big_m)
        l = l + w * l_i
        acc = acc + w * acc_i
    return big_m, l, acc


def _warp(qf, kf, vf, chunks, c, bf16):
    """One warp's (m, l, acc) over its chunks [(t0, t1), ...] in order."""
    shape = qf.shape[:3] + (1,)
    m = torch.full(shape, NEG_INF, device=qf.device)
    l = torch.zeros(shape, device=qf.device)
    acc = torch.zeros_like(qf)
    for t0, t1 in chunks:
        s = torch.einsum("bhgd,bhtd->bhgt", qf, kf[:, :, t0:t1])
        if bf16:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
            # fma(score, c, -m): the product is exact in float64
            p = torch.exp2((s.double() * c.item() - m_new.double())
                           .to(torch.float32))
            pv = p.to(torch.bfloat16).float()
        else:
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = pv = torch.exp2(s - m_new)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgt,bhtd->bhgd", pv,
                                         vf[:, :, t0:t1])
        m = m_new
    return m, l, acc


def decode_attention_split_emulated(q, k, v, pos: int, n_split: int,
                                    scale: float | None = None):
    """q: (B, H, Dh); k/v: (B, T, KV, Dh), float32 or bfloat16 -> (B, H,
    Dh) in q's dtype.

    The splits are those the kernel runs at ``pos`` in a grid of
    ``n_split`` splits (``kernel_splits``)."""
    b, h, dh = q.shape
    kv = k.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    bf16 = q.dtype == torch.bfloat16
    c = torch.tensor(scale, dtype=torch.float32) * \
        torch.tensor(LOG2E, dtype=torch.float32)
    _, rows = kernel_splits(pos, n_split, k.shape[1])
    qf = q.float().reshape(b, kv, h // kv, dh)
    if not bf16:
        qf = qf * c.to(q.device)
    kf = k[:, :pos + 1].float().transpose(1, 2)          # (B, KV, n, Dh)
    vf = v[:, :pos + 1].float().transpose(1, 2)
    splits = []
    for s0 in range(0, pos + 1, rows):
        s1 = min(s0 + rows, pos + 1)
        starts = range(s0, s1, CHUNK)
        splits.append(_merge([
            _warp(qf, kf, vf, [(t, min(t + CHUNK, s1))
                               for t in starts[w::WARPS]], c, bf16)
            for w in range(WARPS)]))
    _, l, acc = splits[0] if len(splits) == 1 else _merge(splits)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(b, h, dh).to(q.dtype)
