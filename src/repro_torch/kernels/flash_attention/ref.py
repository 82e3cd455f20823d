"""Plain PyTorch versions of flash attention (GQA, optional causal) and
of its backward, written out (not autograd)."""
import torch


def _scores(q, k, causal, scale):
    """The scaled, masked fp32 scores (B, KV, G, S, Sk) of head-major q
    (B, H, S, Dh) against k (B, KV, Sk, Dh); masked entries hold -1e30."""
    b, h, s, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    qg = q.reshape(b, kv, h // kv, s, dh)
    scores = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), k.float()) * scale
    if causal:
        idx = (torch.arange(s, device=q.device)[:, None]
               >= torch.arange(sk, device=q.device)[None, :])
        scores = torch.where(idx, scores, torch.tensor(-1e30, device=q.device))
    return scores


def attention_ref(q, k, v, causal: bool = True, scale: float | None = None,
                  return_lse: bool = False):
    """q: (B, H, S, Dh); k/v: (B, KV, Sk, Dh) -> (B, H, S, Dh); with
    ``return_lse`` also each row's log-sum-exp of its scores, (B, H, S)
    float32."""
    b, h, s, dh = q.shape
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    scores = _scores(q, k, causal, scale)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bhkd->bhgqd", probs, v.float())
    out = out.reshape(b, h, s, dh).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(scores, dim=-1).reshape(b, h, s)
    return out


def attention_bwd_ref(q, k, v, out, dout, causal: bool = True,
                      scale: float | None = None):
    """The gradients (dq, dk, dv) of ``attention_ref`` given the output
    ``out`` and its gradient ``dout`` (B, H, S, Dh), in fp32 and rounded to
    the inputs' dtype: P = softmax(S), dV = P^T dO, dP = dO V^T, D =
    rowsum(dO * O), dS = P (dP - D), dQ = scale dS K, dK = scale dS^T Q,
    dK and dV summed over each KV head's query heads."""
    b, h, s, dh = q.shape
    kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    probs = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    qg = q.reshape(b, kv, h // kv, s, dh).float()
    dog = dout.reshape(b, kv, h // kv, s, dh).float()
    og = out.reshape(b, kv, h // kv, s, dh).float()
    dv = torch.einsum("bhgqk,bhgqd->bhkd", probs, dog)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dog, v.float())
    delta = (dog * og).sum(-1, keepdim=True)
    ds = probs * (dp - delta)
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qg) * scale
    return (dq.reshape(b, h, s, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
