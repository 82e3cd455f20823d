"""Plain PyTorch version of single-query (decode) attention with fill mask."""
import torch


def decode_attention_ref(q, k, v, pos: int, scale: float | None = None):
    """q: (B, KV, G, Dh); k/v: (B, KV, T, Dh); attend to t <= pos."""
    b, kv, g, dh = q.shape
    t = k.shape[2]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    s = torch.einsum("bhgd,bhtd->bhgt", q.float(), k.float()) * scale
    mask = torch.arange(t, device=q.device) <= pos
    s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgt,bhtd->bhgd", p, v.float())
    return out.to(q.dtype)
