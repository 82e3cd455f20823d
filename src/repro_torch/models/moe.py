"""Mixture-of-Experts FFN (top-1 / top-k) with sorted capacity dispatch,
the GSPMD path of the JAX package's ``moe_ffn``.

Tokens are sorted by expert id, ranked within their expert by a
searchsorted offset, and gathered into an (E, C, D) expert-major buffer;
entries past an expert's capacity C are dropped (their residual path
passes through untouched).  Every shape is fixed by (tokens, E, k, C) and
no step reads a value back to the host, so a decode step with MoE blocks
can be captured as a CUDA graph.  The expert products are batched
matrix products over the whole buffer: every expert's capacity is
computed at every call, as in the JAX package.

Where a natural PyTorch version would differ from the reference:
  * ties among router probabilities (common: the logits are a bf16
    product) go to the lower expert index, as ``jax.lax.top_k`` gives
    them; ``torch.topk`` promises no order, so the first k of a stable
    descending sort are taken;
  * the dispatch order is a stable argsort, as ``jnp.argsort``, so the
    same entries are dropped past capacity;
  * the scatter-adds (``index_add_``) may add in any order: a buffer slot
    receives at most one real entry plus zeros (the dropped entries, all
    sent to slot (0, 0)), and a token at most k terms starting from
    zero.  x + 0 is x and a + b is b + a, so every order gives the same
    bits.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init


def init_moe(cfg: ModelConfig, generator: torch.Generator):
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.n_experts
    dtype = cfg.compute_dtype
    return {
        "router": dense_init(generator, (d, e), dtype),
        "experts": {
            "w_gate": dense_init(generator, (e, d, f), dtype, in_axis=1),
            "w_up": dense_init(generator, (e, d, f), dtype, in_axis=1),
            "w_down": dense_init(generator, (e, f, d), dtype, in_axis=1),
        },
    }


def expert_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots an expert holds for a call of ``n_tokens`` tokens (B*S in
    prefill, B in decode): ``capacity_factor * k * T / E``, rounded up to
    a multiple of 8, at least 8."""
    cap = int(cfg.capacity_factor * cfg.top_k * n_tokens / cfg.n_experts)
    return max(8, ((cap + 7) // 8) * 8)


def route(cfg: ModelConfig, router, xt):
    """Router of the tokens ``xt`` (T, D): returns (probs (T, E) float32,
    gate values (T, k) renormalised when k > 1, expert ids (T, k))."""
    logits = (xt @ router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    if cfg.top_k > 1:
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
    return probs, gate_vals, gate_idx


def dispatch(cfg: ModelConfig, gate_idx, cap: int):
    """The sorted capacity dispatch of the (T, k) expert ids: returns, in
    dispatch order (entries sorted by expert, stably), each entry's token,
    its index into the flattened (T*k,) gates, its flat buffer slot
    ``expert * cap + rank`` (0 where dropped) and whether it is kept."""
    n, k = gate_idx.shape
    dev = gate_idx.device
    flat_expert = gate_idx.reshape(-1)
    order = torch.argsort(flat_expert, stable=True)
    se = flat_expert[order]
    token = order // k  # entry j of the (T*k,) flattening is token j // k
    starts = torch.searchsorted(
        se, torch.arange(cfg.n_experts, device=dev, dtype=se.dtype))
    rank = torch.arange(n * k, device=dev) - starts[se]
    keep = rank < cap
    slot = torch.where(keep, se * cap + rank, 0)
    return token, order, slot, keep


def moe_ffn(cfg: ModelConfig, params, x):
    """x: (B, S, D) -> ((B, S, D), aux load-balancing loss)."""
    b, s, d = x.shape
    n_tokens = b * s
    e = cfg.n_experts
    cap = expert_capacity(cfg, n_tokens)
    dtype = cfg.compute_dtype
    xt = x.reshape(n_tokens, d)
    probs, gate_vals, gate_idx = route(cfg, params["router"], xt)

    # Switch-style load balancing; the first choice's share a count exact
    # in float32, as the mean of a one-hot
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, gate_idx[:, 0], torch.ones_like(probs[:, 0])) / n_tokens
    aux = e * (me * ce).sum()

    token, order, slot, keep = dispatch(cfg, gate_idx, cap)
    gathered = xt.index_select(0, token) * keep[:, None].to(dtype)
    buf = torch.zeros((e * cap, d), dtype=dtype, device=x.device)
    buf.index_add_(0, slot, gathered)
    buf = buf.view(e, cap, d)

    w = params["experts"]
    h = F.silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_up"])
    out_buf = torch.bmm(h, w["w_down"]).view(e * cap, d)

    # combine back, the gate cast to the compute type before the product
    gate = (gate_vals.reshape(-1)[order] * keep).to(dtype)
    expert_out = out_buf.index_select(0, slot) * gate[:, None]
    yt = torch.zeros_like(xt).index_add_(0, token, expert_out)
    return yt.view(b, s, d), aux
