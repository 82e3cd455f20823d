"""Grouped-query attention with RoPE, optional QKV bias / QK-norm, KV cache.

Three entry points:
  * ``attend_full``   — prefill over a whole sequence (causal or not), through
    the flash-attention kernel,
  * ``attend_decode`` — one new token against a pre-allocated KV cache,
    through the decode-attention kernel,
  * ``attend_cross``  — encoder-decoder cross attention against precomputed
    encoder K/V: the flash-attention kernel over a prompt (its own key
    length), the decode-attention kernel in a decode step.

Activations keep the JAX package's (B, S, H, Dh) layout and the cache its
(B, T, KV, Dh) layout; both kernels read them in place through strides.
Query head h belongs to KV head h // (H / KV), as in the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init
from repro_torch.models.layers import rmsnorm as _rmsnorm


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, T, KV, Dh)
    v: torch.Tensor  # (B, T, KV, Dh)


def init_attention(cfg: ModelConfig, generator: torch.Generator,
                   cross: bool = False):
    """A cross-attention block (``cross``) has no QKV bias, as in the JAX
    package."""
    d, h, kv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dtype, device = cfg.compute_dtype, generator.device
    p = {
        "wq": dense_init(generator, (d, h, dh), dtype),
        "wk": dense_init(generator, (d, kv, dh), dtype),
        "wv": dense_init(generator, (d, kv, dh), dtype),
        "wo": dense_init(generator, (h, dh, d), dtype, in_axis=0),
    }
    if cfg.qkv_bias and not cross:
        p["bq"] = torch.zeros((h, dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((kv, dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((kv, dh), dtype=dtype, device=device)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=cfg.param_dtype, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=cfg.param_dtype, device=device)
    return p


def _project(x, w):
    """x: (B, S, D); w: (D, heads, Dh) -> (B, S, heads, Dh)."""
    b, s, d = x.shape
    return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _project_q(cfg, params, x):
    q = _project(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"]
    if cfg.qk_norm:
        q = _rmsnorm(q, {"scale": params["q_norm"]}, cfg.norm_eps)
    return q


def _project_kv(cfg, params, x):
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "bk" in params:
        k = k + params["bk"]
        v = v + params["bv"]
    if cfg.qk_norm:
        k = _rmsnorm(k, {"scale": params["k_norm"]}, cfg.norm_eps)
    return k, v


def _out_proj(params, out):
    """out: (B, S, H, Dh) -> (B, S, D)."""
    b, s = out.shape[:2]
    wo = params["wo"]
    return out.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def attend_full(cfg: ModelConfig, params, x, positions, causal=None):
    """Full-sequence attention (prefill). Returns (out, KVCache)."""
    causal = cfg.causal if causal is None else causal
    q = _project_q(cfg, params, x)
    k, v = _project_kv(cfg, params, x)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = fa_ops.flash_attention(q, k, v, causal=causal,
                                 scale=1.0 / (cfg.d_head ** 0.5))
    return _out_proj(params, out), KVCache(k=k, v=v)


def attend_decode(cfg: ModelConfig, params, x, cache: KVCache, pos):
    """One-token decode. ``x``: (B, 1, D); ``pos``: index of the new token,
    an int or a one-element int64 tensor on x's device.

    Writes K/V at ``pos`` into ``cache`` in place (where the JAX package
    donates the cache buffer) and attends to positions <= pos.  The
    position is used only as a device tensor, as the JAX package traces
    it, so a captured step follows it."""
    b = x.shape[0]
    pos_t = torch.as_tensor(pos, dtype=torch.int64, device=x.device).reshape(1)
    q = _project_q(cfg, params, x)                   # (B,1,H,Dh)
    k_new, v_new = _project_kv(cfg, params, x)       # (B,1,KV,Dh)
    posv = pos_t.expand(b)[:, None]
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)
    cache.k.index_copy_(1, pos_t, k_new)
    cache.v.index_copy_(1, pos_t, v_new)
    out = da_ops.decode_attention(q[:, 0], cache.k, cache.v, pos_t,
                                  scale=1.0 / (cfg.d_head ** 0.5))
    return _out_proj(params, out[:, None]), cache


def attend_cross(cfg: ModelConfig, params, x, memory_kv: KVCache, pos=None):
    """Cross attention of ``x`` (B, S, D) against precomputed encoder K/V
    (B, T, KV, Dh): no RoPE, no mask.  ``pos`` None: a prompt, through
    the flash-attention kernel with its own key length T, not causal.
    ``pos`` given, a one-element int64 tensor on x's device holding
    T - 1: one decode step (S 1) through the decode-attention kernel over
    all T positions; a captured step reads the position from that
    tensor, which lives with the cache."""
    q = _project_q(cfg, params, x)
    scale = 1.0 / (cfg.d_head ** 0.5)
    if pos is None:
        out = fa_ops.flash_attention(q, memory_kv.k, memory_kv.v,
                                     causal=False, scale=scale)
    else:
        out = da_ops.decode_attention(q[:, 0], memory_kv.k, memory_kv.v,
                                      pos, scale=scale)[:, None]
    return _out_proj(params, out)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  dtype=None) -> KVCache:
    """Zero-filled, as in the JAX package: a slot past the fill level never
    holds NaN bits, whatever reads it."""
    dtype = dtype or cfg.compute_dtype
    shape = (batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))
