"""Decoder model: init / prefill / decode for every block kind of
``repro.models.transformer`` that serving runs: a mixer (attention, Mamba,
mLSTM or sLSTM) and an FFN (dense SwiGLU, MoE or none) per position of
the period.

The stack is a Python loop over ``cfg.n_periods`` periods of
``cfg.period`` blocks; parameters are named as the JAX pytree
(``blocks.<period>.<position>.attn.wq``, ``...moe.router``,
``...moe.experts.w_gate``, ``...mamba.A_log``).  Every residual add that
a norm follows runs fused with that norm (``layers.add_rmsnorm``): the
mixer's add with the block's ``norm2`` where it has an FFN, the FFN's add
(or, without an FFN, the mixer's) with the next block's ``norm1`` or,
after the last block, the final norm.  The decode cache keeps the JAX
layout, one state per period position (a ``KVCache``, ``MambaState``,
``MLSTMState`` or ``SLSTMState``) with a leading ``n_periods`` axis, and
is written in place.  A decode step reads its position from the device
(``DecodeCache.pos_t``) and advances it there, so the step holds no host
value and can be captured as a CUDA graph.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import (FFN_DENSE, FFN_MOE, MIXER_ATTN,
                                       MIXER_MAMBA, MIXER_MLSTM, MIXER_SLSTM,
                                       BlockSpec, ModelConfig)

# Parameters that keep cfg.param_dtype (norm scales, and what the JAX
# package reads in float32); every other one is a matrix or bias and is
# held in cfg.compute_dtype.
_PARAM_DTYPE = ("scale", "q_norm", "k_norm", "A_log", "D", "dt_bias")

_FULL = {MIXER_MAMBA: ssm.mamba_full, MIXER_MLSTM: ssm.mlstm_full,
         MIXER_SLSTM: ssm.slstm_full}
_DECODE = {MIXER_MAMBA: ssm.mamba_decode, MIXER_MLSTM: ssm.mlstm_decode,
           MIXER_SLSTM: ssm.slstm_decode}


class DecodeCache(NamedTuple):
    """Per-model decode state: a tuple over period positions of each
    block's state with a leading ``n_periods`` axis (KV caches
    (n_periods, B, T, KV, Dh); recurrent states as ``models.ssm`` shapes
    them), the next position to write, twice: ``pos`` on the host, for
    bounds checks only, and ``pos_t``, a one-element int64 tensor on the
    cache's device, which every computation reads and ``decode_step``
    advances in place; and ``max_len``, the positions it holds."""
    blocks: Tuple[NamedTuple, ...]
    pos: int
    pos_t: torch.Tensor
    max_len: int

    def zero_(self) -> None:
        """Zeroes every state and pos_t in place."""
        for state in self.blocks:
            for t in state:
                t.zero_()
        self.pos_t.zero_()


def _check_supported(cfg: ModelConfig) -> None:
    reason = None
    if cfg.is_encdec:
        reason = "the encoder-decoder path"
    elif cfg.frontend != "none":
        reason = f"the {cfg.frontend} frontend"
    elif cfg.sliding_window is not None:
        reason = "sliding-window attention"
    if reason:
        raise NotImplementedError(
            f"{cfg.name}: the torch Model runs decoder-only stacks; {reason} "
            f"comes with ROADMAP queue A, 'The rest of the model zoo'")


def _has_norm2(cfg: ModelConfig, spec: BlockSpec) -> bool:
    return spec.ffn == FFN_MOE or (spec.ffn == FFN_DENSE and cfg.d_ff > 0)


def _init_block(cfg: ModelConfig, spec: BlockSpec, generator):
    dev = generator.device
    init_mixer = {MIXER_ATTN: attn.init_attention, MIXER_MAMBA: ssm.init_mamba,
                  MIXER_MLSTM: ssm.init_mlstm, MIXER_SLSTM: ssm.init_slstm}
    p = {"norm1": L.init_rmsnorm(cfg, dev),
         spec.mixer: init_mixer[spec.mixer](cfg, generator)}
    if _has_norm2(cfg, spec):
        p["norm2"] = L.init_rmsnorm(cfg, dev)
        if spec.ffn == FFN_MOE:
            p["moe"] = moe_mod.init_moe(cfg, generator)
        else:
            p["mlp"] = L.init_mlp(cfg, generator)
    return p


class _ParamTree(nn.Module):
    """Parameters and sub-trees under keys, read as ``tree[key]``: the MoE
    block's ``router`` beside its ``experts``, which a ParameterDict
    cannot hold."""

    def __init__(self, **children: nn.Module):
        super().__init__()
        for name, child in children.items():
            self.add_module(name, child)

    def __getitem__(self, key):
        return getattr(self, key)

    def __setitem__(self, key, value: nn.Parameter):
        self.register_parameter(key, value)


def _block_module(cfg: ModelConfig, spec: BlockSpec) -> nn.ModuleDict:
    m = {"norm1": nn.ParameterDict(), spec.mixer: nn.ParameterDict()}
    if _has_norm2(cfg, spec):
        m["norm2"] = nn.ParameterDict()
        if spec.ffn == FFN_MOE:
            m["moe"] = _ParamTree(experts=nn.ParameterDict())
        else:
            m["mlp"] = nn.ParameterDict()
    return nn.ModuleDict(m)


def _residuals(cfg, spec, block, x, out, next_norm):
    """The rest of a block after its mixer output ``out``: the residual
    add fused with ``norm2``, the FFN, and its add fused with
    ``next_norm``; without an FFN the mixer's add is fused with
    ``next_norm``.  Returns (x, next_norm(x)).  A MoE block's aux loss is
    dropped, as the reference's prefill and decode drop it."""
    if "norm2" in block:
        x, h2 = L.add_rmsnorm(x, out, block["norm2"], cfg.norm_eps)
        out = (moe_mod.moe_ffn(cfg, block["moe"], h2)[0]
               if spec.ffn == FFN_MOE else L.mlp(cfg, block["mlp"], h2))
    return L.add_rmsnorm(x, out, next_norm, cfg.norm_eps)


def _state_zeros(cfg: ModelConfig, spec: BlockSpec, batch: int,
                 max_len: int, device):
    lead = (cfg.n_periods,)
    if spec.mixer == MIXER_ATTN:
        shape = (*lead, batch, max_len, cfg.n_kv_heads, cfg.d_head)
        return attn.KVCache(*(torch.zeros(shape, dtype=cfg.compute_dtype,
                                          device=device) for _ in range(2)))
    init = {MIXER_MAMBA: ssm.init_mamba_state,
            MIXER_MLSTM: ssm.init_mlstm_state,
            MIXER_SLSTM: ssm.init_slstm_state}[spec.mixer]
    return init(cfg, batch, device, lead)


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
    """The decoder.  ``Model(cfg)`` holds no tensors until
    ``init(generator)`` draws them or ``load(params)`` takes them; the model
    then lives on that device."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = nn.ParameterDict()
        self.final_norm = nn.ParameterDict()
        self.blocks = nn.ModuleList(
            nn.ModuleList(_block_module(cfg, spec) for spec in cfg.period)
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
            dtype = (self.cfg.param_dtype if key in _PARAM_DTYPE
                     else self.cfg.compute_dtype)
            self.get_submodule(path)[key] = nn.Parameter(
                t.to(dtype), requires_grad=False)
        return self

    # -- serving -------------------------------------------------------------
    def _layers(self):
        """(period, position, spec, block, the norm after the block) for
        every block in order; the norm after the last block is the final
        norm."""
        flat = [(p, i, spec, block) for p, period in enumerate(self.blocks)
                for (i, block), spec in zip(enumerate(period),
                                            self.cfg.period)]
        after = [block["norm1"] for *_, block in flat[1:]]
        return [(*layer, norm) for layer, norm
                in zip(flat, after + [self.final_norm])]

    def init_cache(self, batch: int, max_len: int,
                   filled: Optional[int] = None) -> DecodeCache:
        blocks = tuple(_state_zeros(self.cfg, spec, batch, max_len,
                                    self.device) for spec in self.cfg.period)
        pos = filled or 0
        return DecodeCache(blocks=blocks, pos=pos, pos_t=torch.full(
            (1,), pos, dtype=torch.int64, device=self.device),
            max_len=max_len)

    @torch.inference_mode()
    def prefill(self, tokens, max_len: Optional[int] = None,
                cache: Optional[DecodeCache] = None):
        """Run the prompt ``tokens`` (B, S); returns (last-token logits
        (B, 1, padded_vocab), DecodeCache).

        KV caches are written into ``max_len``-long zeroed buffers so
        decode can continue in place, and each recurrent block's state is
        the one after the prompt, from zeros; ``cache`` given, it is that
        cache's buffers (zeroed first: nothing of an earlier prompt
        carries over), and its ``pos_t`` is set to S in place."""
        cfg = self.cfg
        b, s = tokens.shape
        if cache is None:
            max_len = max_len or s
            if max_len < s:
                raise ValueError(f"max_len {max_len} < prompt length {s}")
            cache = self.init_cache(b, max_len, filled=s)
        else:
            if (cache.blocks[0][0].shape[1] != b or cache.max_len < s
                    or max_len not in (None, cache.max_len)):
                raise ValueError(
                    f"a cache of {cache.blocks[0][0].shape[1]} sequences of "
                    f"{cache.max_len} positions cannot take {b} prompts of "
                    f"{s} tokens")
            cache.zero_()
            cache.pos_t.fill_(s)
            cache = cache._replace(pos=s)
        x = L.embed(cfg, self.embed, tokens)
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        positions = torch.arange(s, device=x.device)[None, :]
        for p, i, spec, block, norm in self._layers():
            params, dst = block[spec.mixer], cache.blocks[i]
            if spec.mixer == MIXER_ATTN:
                out, kv = attn.attend_full(cfg, params, h, positions)
                dst.k[p, :, :s] = kv.k
                dst.v[p, :, :s] = kv.v
            else:
                out, state = _FULL[spec.mixer](cfg, params, h)
                for t, new in zip(dst, state):
                    t[p].copy_(new)
            x, h = _residuals(cfg, spec, block, x, out, norm)
        return L.lm_logits(cfg, self.embed, h[:, -1:]), cache

    @torch.inference_mode()
    def decode_step(self, cache: DecodeCache, tokens):
        """tokens: (B, 1) the token sampled at position cache.pos_t - 1;
        returns logits for position cache.pos_t and the cache, updated in
        place: K/V written at pos_t, each recurrent state replaced by the
        next, then pos_t advanced by one.  Only the bounds check reads the
        host's ``cache.pos``."""
        cfg = self.cfg
        pos = cache.pos
        if pos >= cache.max_len:
            raise ValueError(f"decode position {pos} is past the cache")
        x = L.embed(cfg, self.embed, tokens)
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        for p, i, spec, block, norm in self._layers():
            params = block[spec.mixer]
            state = type(cache.blocks[i])(*(t[p] for t in cache.blocks[i]))
            if spec.mixer == MIXER_ATTN:
                out, _ = attn.attend_decode(cfg, params, h, state,
                                            cache.pos_t)
            else:
                out, new = _DECODE[spec.mixer](cfg, params, h, state)
                for t, n in zip(state, new):
                    t.copy_(n)
            x, h = _residuals(cfg, spec, block, x, out, norm)
        logits = L.lm_logits(cfg, self.embed, h)
        cache.pos_t.add_(1)
        return logits, cache._replace(pos=pos + 1)
