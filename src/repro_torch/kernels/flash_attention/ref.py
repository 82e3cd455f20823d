"""Plain PyTorch version of flash attention (GQA, optional causal)."""
import torch


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None):
    """q: (B, H, S, Dh); k/v: (B, KV, Sk, Dh) -> (B, H, S, Dh)."""
    b, h, s, dh = q.shape
    _, kv, sk, _ = k.shape
    group = h // kv
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    qg = q.reshape(b, kv, group, s, dh)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        idx = (torch.arange(s, device=q.device)[:, None]
               >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(idx, scores, torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    return out.reshape(b, h, s, dh).to(q.dtype)
