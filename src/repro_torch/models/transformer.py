"""Dense decoder model: init / prefill / decode for attention + dense-FFN
stacks, the path of ``repro.models.transformer`` that serving runs.

The stack is a Python loop over ``cfg.n_periods`` periods of
``cfg.period`` blocks; parameters live in ``nn.ParameterDict``s named as the
JAX pytree (``blocks.<period>.<position>.attn.wq``).  Every residual add
that a norm follows runs fused with that norm (``layers.add_rmsnorm``): the
attention add with the block's ``norm2``, the MLP add with the next block's
``norm1`` or, after the last block, the final norm.  The decode cache keeps
the JAX layout, one ``KVCache`` per period position with a leading
``n_periods`` axis, and is written in place.  A decode step reads its
position from the device (``DecodeCache.pos_t``) and advances it there, so
the step holds no host value and can be captured as a CUDA graph.
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
    with a leading ``n_periods`` axis, (n_periods, B, T, KV, Dh), and the
    next position to write, twice: ``pos`` on the host, for bounds checks
    only, and ``pos_t``, a one-element int64 tensor on the cache's device,
    which every computation reads and ``decode_step`` advances in place."""
    blocks: Tuple[attn.KVCache, ...]
    pos: int
    pos_t: torch.Tensor


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


def _residuals(cfg, p, x, out, next_norm):
    """The rest of a block after its attention output ``out``: the residual
    add fused with ``norm2``, the MLP, and its add fused with
    ``next_norm``.  Returns (x, next_norm(x))."""
    if cfg.d_ff > 0:
        x, h2 = L.add_rmsnorm(x, out, p["norm2"], cfg.norm_eps)
        out = L.mlp(cfg, p["mlp"], h2)
    return L.add_rmsnorm(x, out, next_norm, cfg.norm_eps)


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
    def _layers(self):
        """(period, position, block, the norm after the block) for every
        block in order; the norm after the last block is the final norm."""
        flat = [(p, i, block) for p, period in enumerate(self.blocks)
                for i, block in enumerate(period)]
        after = [block["norm1"] for _, _, block in flat[1:]]
        return [(p, i, block, norm) for (p, i, block), norm
                in zip(flat, after + [self.final_norm])]

    def init_cache(self, batch: int, max_len: int,
                   filled: Optional[int] = None) -> DecodeCache:
        cfg = self.cfg
        shape = (cfg.n_periods, batch, max_len, cfg.n_kv_heads, cfg.d_head)

        def zeros():
            return torch.zeros(shape, dtype=cfg.compute_dtype,
                               device=self.device)

        blocks = tuple(attn.KVCache(k=zeros(), v=zeros()) for _ in cfg.period)
        pos = filled or 0
        return DecodeCache(blocks=blocks, pos=pos, pos_t=torch.full(
            (1,), pos, dtype=torch.int64, device=self.device))

    @torch.inference_mode()
    def prefill(self, tokens, max_len: Optional[int] = None,
                cache: Optional[DecodeCache] = None):
        """Run the prompt ``tokens`` (B, S); returns (last-token logits
        (B, 1, padded_vocab), DecodeCache).

        The KV cache is written into a ``max_len``-long zeroed buffer so
        decode can continue in place; ``cache`` given, it is that cache's
        buffers (zeroed first), and its ``pos_t`` is set to S in place."""
        cfg = self.cfg
        b, s = tokens.shape
        if cache is None:
            max_len = max_len or s
            if max_len < s:
                raise ValueError(f"max_len {max_len} < prompt length {s}")
            cache = self.init_cache(b, max_len, filled=s)
        else:
            shape = cache.blocks[0].k.shape
            if shape[1] != b or shape[2] < s or max_len not in (None,
                                                                shape[2]):
                raise ValueError(f"a cache of {tuple(shape)} cannot take "
                                 f"{b} prompts of {s} tokens")
            for kv in cache.blocks:
                kv.k.zero_()
                kv.v.zero_()
            cache.pos_t.fill_(s)
            cache = cache._replace(pos=s)
        x = L.embed(cfg, self.embed, tokens)
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        positions = torch.arange(s, device=x.device)[None, :]
        for p, i, block, norm in self._layers():
            out, kv = attn.attend_full(cfg, block["attn"], h, positions)
            x, h = _residuals(cfg, block, x, out, norm)
            cache.blocks[i].k[p, :, :s] = kv.k
            cache.blocks[i].v[p, :, :s] = kv.v
        return L.lm_logits(cfg, self.embed, h[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: DecodeCache, tokens):
        """tokens: (B, 1) the token sampled at position cache.pos_t - 1;
        returns logits for position cache.pos_t and the cache, updated in
        place: K/V written at pos_t, then pos_t advanced by one.  Only the
        bounds check reads the host's ``cache.pos``."""
        cfg = self.cfg
        pos = cache.pos
        if pos >= cache.blocks[0].k.shape[2]:
            raise ValueError(f"decode position {pos} is past the cache")
        x = L.embed(cfg, self.embed, tokens)
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        for p, i, block, norm in self._layers():
            kv = attn.KVCache(k=cache.blocks[i].k[p], v=cache.blocks[i].v[p])
            out, _ = attn.attend_decode(cfg, block["attn"], h, kv,
                                        cache.pos_t)
            x, h = _residuals(cfg, block, x, out, norm)
        logits = L.lm_logits(cfg, self.embed, h)
        cache.pos_t.add_(1)
        return logits, cache._replace(pos=pos + 1)
