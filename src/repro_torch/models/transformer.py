"""Dense decoder model: init / prefill / decode for attention + dense-FFN
stacks, the path of ``repro.models.transformer`` that serving runs.

The stack is a Python loop over ``cfg.n_periods`` periods of
``cfg.period`` blocks; parameters live in ``nn.ParameterDict``s named as the
JAX pytree (``blocks.<period>.<position>.attn.wq``).  The decode cache keeps
the JAX layout, one ``KVCache`` per period position with a leading
``n_periods`` axis, and is written in place.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.config import (FFN_DENSE, MIXER_ATTN, BlockSpec,
                                       ModelConfig)

# Parameters that keep cfg.param_dtype; every other one is a matrix or bias
# and is held in cfg.compute_dtype.
_NORM_PARAMS = ("scale", "q_norm", "k_norm")


class DecodeCache(NamedTuple):
    """Per-model decode state: a tuple over period positions of KV caches
    with a leading ``n_periods`` axis, (n_periods, B, T, KV, Dh)."""
    blocks: Tuple[attn.KVCache, ...]
    pos: int  # next position to write


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = [b for b in cfg.period
                   if b.mixer != MIXER_ATTN or b.ffn != FFN_DENSE]
    reason = None
    if unsupported:
        reason = f"blocks {unsupported} (MoE, Mamba and xLSTM blocks)"
    elif cfg.is_encdec:
        reason = "the encoder-decoder path"
    elif cfg.frontend != "none":
        reason = f"the {cfg.frontend} frontend"
    elif cfg.sliding_window is not None:
        reason = "sliding-window attention"
    if reason:
        raise NotImplementedError(
            f"{cfg.name}: the torch Model runs attention + dense-FFN blocks "
            f"only; {reason} come with ROADMAP queue A, 'The rest of the "
            f"model zoo'")


def _init_block(cfg: ModelConfig, spec: BlockSpec, generator):
    p = {"norm1": L.init_rmsnorm(cfg, generator.device),
         "attn": attn.init_attention(cfg, generator)}
    if cfg.d_ff > 0:
        p["norm2"] = L.init_rmsnorm(cfg, generator.device)
        p["mlp"] = L.init_mlp(cfg, generator)
    return p


def _apply_block_full(cfg, p, x, positions):
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    out, kv = attn.attend_full(cfg, p["attn"], h, positions)
    x = x + out
    if cfg.d_ff > 0:
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        x = x + L.mlp(cfg, p["mlp"], h2)
    return x, kv


def _apply_block_decode(cfg, p, x, kv: attn.KVCache, pos: int):
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    out, _ = attn.attend_decode(cfg, p["attn"], h, kv, pos)
    x = x + out
    if cfg.d_ff > 0:
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        x = x + L.mlp(cfg, p["mlp"], h2)
    return x


def flatten_params(prefix: str, tree: dict) -> dict:
    """Nested dicts -> ``{"<prefix>.<key>.<key>": leaf}``, as ``Model.load``
    names its parameters."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(flatten_params(name, v) if isinstance(v, dict)
                   else {name: v})
    return out


class Model(nn.Module):
    """The dense decoder.  ``Model(cfg)`` holds no tensors until
    ``init(generator)`` draws them or ``load(params)`` takes them; the model
    then lives on that device."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.ParameterDict()
        self.final_norm = nn.ParameterDict()
        self.blocks = nn.ModuleList(
            nn.ModuleList(
                nn.ModuleDict({name: nn.ParameterDict()
                               for name in ("norm1", "attn", "norm2", "mlp")})
                for _ in cfg.period)
            for _ in range(cfg.n_periods))

    @property
    def device(self) -> torch.device:
        return self.embed["tok_embed"].device

    # -- parameters ----------------------------------------------------------
    def init(self, generator: torch.Generator) -> "Model":
        """Draws every parameter from ``generator``, on its device."""
        cfg = self.cfg
        params = flatten_params("embed", L.init_embeddings(cfg, generator))
        params.update(flatten_params(
            "final_norm", L.init_rmsnorm(cfg, generator.device)))
        for p in range(cfg.n_periods):
            for i, spec in enumerate(cfg.period):
                params.update(flatten_params(
                    f"blocks.{p}.{i}", _init_block(cfg, spec, generator)))
        return self.load(params)

    def load(self, params: Dict[str, torch.Tensor]) -> "Model":
        """Takes parameters named ``<module path>.<key>`` (as ``init`` and
        ``repro_torch.weights.params_from_jax`` make them), casting each
        matrix to ``cfg.compute_dtype`` once."""
        for name, t in params.items():
            path, key = name.rsplit(".", 1)
            dtype = (self.cfg.param_dtype if key in _NORM_PARAMS
                     else self.cfg.compute_dtype)
            self.get_submodule(path)[key] = nn.Parameter(
                t.to(dtype), requires_grad=False)
        return self

    # -- serving -------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   filled: Optional[int] = None) -> DecodeCache:
        cfg = self.cfg
        shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads, cfg.d_head)

        def zeros():
            return torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=self.device)

        blocks = tuple(attn.KVCache(k=zeros(), v=zeros()) for _ in cfg.period)
        return DecodeCache(blocks=blocks, pos=filled or 0)

    @torch.inference_mode()
    def prefill(self, tokens, max_len: Optional[int] = None):
        """Run the prompt ``tokens`` (B, S); returns (last-token logits
        (B, 1, padded_vocab), DecodeCache).

        The KV cache is written into a ``max_len``-long zeroed buffer so
        decode can continue in place."""
        cfg = self.cfg
        b, s = tokens.shape
        max_len = max_len or s
        if max_len < s:
            raise ValueError(f"max_len {max_len} < prompt length {s}")
        cache = self.init_cache(b, max_len, filled=s)
        x = L.embed(cfg, self.embed, tokens)
        positions = torch.arange(s, device=x.device)[None, :]
        for p, period in enumerate(self.blocks):
            for i, block in enumerate(period):
                x, kv = _apply_block_full(cfg, block, x, positions)
                cache.blocks[i].k[p, :, :s] = kv.k
                cache.blocks[i].v[p, :, :s] = kv.v
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        return L.lm_logits(cfg, self.embed, x[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: DecodeCache, tokens):
        """tokens: (B, 1) the token sampled at cache.pos-1; returns logits
        for position cache.pos and the cache, updated in place."""
        cfg = self.cfg
        pos = cache.pos
        if pos >= cache.blocks[0].k.shape[2]:
            raise ValueError(f"decode position {pos} is past the cache")
        x = L.embed(cfg, self.embed, tokens)
        for p, period in enumerate(self.blocks):
            for i, block in enumerate(period):
                kv = attn.KVCache(k=cache.blocks[i].k[p],
                                  v=cache.blocks[i].v[p])
                x = _apply_block_decode(cfg, block, x, kv, pos)
        x = L.rmsnorm(x, self.final_norm, cfg.norm_eps)
        logits = L.lm_logits(cfg, self.embed, x)
        return logits, DecodeCache(blocks=cache.blocks, pos=pos + 1)
