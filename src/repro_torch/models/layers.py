"""Core layer primitives of the dense transformer.

``init_*`` functions return plain dicts of tensors drawn from an explicit
``torch.Generator`` on its device; apply functions are plain functions on
tensors.  A serving model holds its matrices in ``cfg.compute_dtype`` (the
JAX package casts them at every use, with the same rounding); a training
model holds every parameter in ``cfg.param_dtype`` and casts each matrix
at its use, as the JAX package does (``models.transformer``).  Norm scales
stay in ``cfg.param_dtype`` and norms are computed in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed.compat import DTensor, Replicate
from repro_torch.distributed.local import (local, matmul,
                                           partial_over_shards,
                                           row_placements, wrap)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.models.config import ModelConfig


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, shape, dtype, in_axis: int = 0):
    """Truncated-normal fan-in init: N(0, 1/fan_in) cut at +-2 sigma.

    Drawn in fp32 on the generator's device and cast at once, so a model
    initialised tensor by tensor peaks near its size in ``dtype``."""
    std = 1.0 / max(shape[in_axis], 1) ** 0.5
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    if t.device.type != "meta":
        torch.nn.init.trunc_normal_(t, std=std, a=-2.0 * std, b=2.0 * std,
                                    generator=generator)
    return t.to(dtype)


class _ShapeOnly:
    """Stands for a generator where only shapes are wanted: every
    ``init_*`` puts its tensors on the meta device and draws nothing."""
    device = torch.device("meta")


SHAPE_ONLY = _ShapeOnly()


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(cfg: ModelConfig, device, dim: Optional[int] = None):
    return {"scale": torch.ones((dim or cfg.d_model,), dtype=cfg.param_dtype,
                                device=device)}


def rmsnorm(x, params, eps: float = 1e-5):
    return rms_ops.rmsnorm(x, params["scale"], eps=eps)


def add_rmsnorm(x, r, params, eps: float = 1e-5):
    """The residual add ``x + r`` and the norm after it, in one kernel:
    returns (x + r, rmsnorm(x + r))."""
    return rms_ops.add_rmsnorm(x, r, params["scale"], eps=eps)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device=None):
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32,
                            device=device) / d_head
    return 1.0 / (theta ** exponent)  # (d_head/2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, Dh); positions: broadcastable to (..., S).

    Split-halves layout, math in fp32, cast back to ``x.dtype``."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def init_mlp(cfg: ModelConfig, generator: torch.Generator):
    d, f, dtype = cfg.d_model, cfg.d_ff, cfg.compute_dtype
    return {
        "w_gate": dense_init(generator, (d, f), dtype),
        "w_up": dense_init(generator, (d, f), dtype),
        "w_down": dense_init(generator, (f, d), dtype),
    }


def mlp(cfg: ModelConfig, params, x):
    g = matmul(x, params["w_gate"])
    u = matmul(x, params["w_up"])
    return matmul(F.silu(g) * u, params["w_down"])


# ---------------------------------------------------------------------------
# Embeddings / LM head
# ---------------------------------------------------------------------------

def init_embeddings(cfg: ModelConfig, generator: torch.Generator):
    dtype = cfg.compute_dtype
    p = {"tok_embed": dense_init(generator, (cfg.padded_vocab, cfg.d_model),
                                 dtype, in_axis=1)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                                  dtype)
    return p


def embed(cfg: ModelConfig, params, tokens):
    # gathered, then cast to the compute dtype (a no-op when it holds it)
    table = params["tok_embed"]
    if isinstance(table, DTensor):
        return _embed_sharded(table, tokens).to(cfg.compute_dtype)
    return table[tokens].to(cfg.compute_dtype)


def _embed_sharded(table, tokens):
    """The gather of a DTensor ``table``: each rank takes its own tokens'
    rows from the whole table, by the same indexing as one device (so its
    gradient adds up in the same order); the table's gradient is then a
    pending sum over the ranks that hold other tokens."""
    mesh = table.device_mesh
    pl = (tokens.placements if isinstance(tokens, DTensor)
          else (Replicate(),) * mesh.ndim)
    rows = local(table, mesh, (Replicate(),) * mesh.ndim,
                 partial_over_shards(pl))[local(tokens, mesh, pl)]
    return wrap(rows, mesh, pl, (*tokens.shape, table.shape[1]))


def lm_logits(cfg: ModelConfig, params, x):
    w = params["tok_embed"].T if cfg.tie_embeddings else params["lm_head"]
    return matmul(x, w.to(cfg.compute_dtype))


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------

# rows of logits widened to fp32 at a time: about 1 GB of fp32 temporaries
# at a 152k vocabulary, where the whole (B*S, V) in fp32 would take 10 GB
# at qwen3-0.6b's training shape
CE_CHUNK_ELEMENTS = 2 ** 28


class _CrossEntropy(torch.autograd.Function):
    """The mean CE of the reference's ``layers.cross_entropy`` with its
    gradient written out, ``(softmax - onehot) * mask / count``, over row
    chunks: it saves the logits as they are and each row's log-sum-exp,
    never a full fp32 copy.  Its forward and backward are profiler ranges
    (``cross_entropy``, ``cross_entropy_bwd``), which a traced training
    step reads to attribute their device time."""

    @staticmethod
    @torch.profiler.record_function("cross_entropy")
    def forward(ctx, logits, labels, vocab_size, count=None):
        v = logits.shape[-1]
        flat, lab = logits.reshape(-1, v), labels.reshape(-1)
        mask = (lab >= 0) & (lab < vocab_size)
        safe = torch.where(mask, lab, 0)
        rows = max(1, CE_CHUNK_ELEMENTS // v)
        lse = torch.cat([torch.logsumexp(flat[i:i + rows].float(), dim=-1)
                         for i in range(0, flat.shape[0], rows)])
        gold = flat.gather(1, safe[:, None])[:, 0].float()
        if count is None:
            count = mask.sum().clamp_min(1)
        ctx.save_for_backward(logits, safe, mask, lse, count)
        return ((lse - gold) * mask).sum() / count

    @staticmethod
    @torch.profiler.record_function("cross_entropy_bwd")
    def backward(ctx, g):
        logits, safe, mask, lse, count = ctx.saved_tensors
        v = logits.shape[-1]
        flat = logits.reshape(-1, v)
        weight = mask.float() * (g / count)
        grad = torch.empty_like(flat)
        rows = max(1, CE_CHUNK_ELEMENTS // v)
        for i in range(0, flat.shape[0], rows):
            sl = slice(i, i + rows)
            p = torch.exp(flat[sl].float() - lse[sl, None])
            p[torch.arange(p.shape[0], device=p.device), safe[sl]] -= 1.0
            grad[sl] = (p * weight[sl, None]).to(grad.dtype)
        return grad.view_as(logits), None, None, None


def cross_entropy(logits, labels, vocab_size: int):
    """Mean CE in fp32 over the last axis of ``logits`` (the padded
    vocabulary, padding columns included, as the reference computes it);
    labels < 0 or >= vocab_size (padding) are masked.

    DTensor logits (under a sharding policy): each rank takes its rows
    with the vocabulary whole (``distributed.local.row_placements``), and
    the labels alike, and sums its rows' CE over the global count of
    unmasked labels; the ranks' sums add up to the mean."""
    if not isinstance(logits, DTensor):
        return _CrossEntropy.apply(logits, labels, vocab_size)
    mesh, pl = logits.device_mesh, row_placements(logits)
    lab = local(labels, mesh, pl)
    count = wrap(((lab >= 0) & (lab < vocab_size)).sum(), mesh,
                 partial_over_shards(pl), ()).full_tensor().clamp_min(1)
    loss = _CrossEntropy.apply(local(logits, mesh, pl), lab, vocab_size,
                               count)
    return wrap(loss, mesh, partial_over_shards(pl), ()).redistribute(
        mesh, (Replicate(),) * mesh.ndim)
