"""The model: init / train_loss / encode / prefill / decode for every
block kind of ``repro.models.transformer``: a mixer (attention, Mamba,
mLSTM or sLSTM) and an FFN (dense SwiGLU, MoE or none) per position of
the period; whisper's encoder stack and cross attention; internvl2's
vision frontend.

A serving model (``init``/``load`` without ``train``) holds each matrix
in ``cfg.compute_dtype``, cast once, with no gradient.  A training model
(``train=True``) holds every parameter in ``cfg.param_dtype`` with
``requires_grad`` and casts each matrix to ``cfg.compute_dtype`` at its
use, as the JAX package does; ``train_loss`` runs the same fused block
order as prefill, through the same kernels, whose backward is a kernel
too (``kernels/rmsnorm``, ``kernels/flash_attention``).

The stack is a Python loop over ``cfg.n_periods`` periods of
``cfg.period`` blocks; parameters are named as the JAX pytree
(``blocks.<period>.<position>.attn.wq``, ``...moe.router``,
``...moe.experts.w_gate``, ``...mamba.A_log``, ``...cross_attn.wq``,
``enc_blocks.<layer>.mlp.w_up``, ``enc_norm.scale``, ``vis_proj``).
Every residual add that a norm follows runs fused with that norm
(``layers.add_rmsnorm``): the mixer's add with the block's
``cross_norm`` in a decoder block with cross attention, the cross add (or,
without one, the mixer's add) with ``norm2`` where the block has an FFN,
the FFN's add (or, without an FFN, the last add) with the next block's
``norm1`` or, after the last block, the final norm (``enc_norm`` after
the encoder's last block).  The decode cache keeps the JAX layout, one
state per period position (a ``KVCache``, ``MambaState``, ``MLSTMState``
or ``SLSTMState``) with a leading ``n_periods`` axis, and the encoder's
K/V per decoder layer in ``cross``; it is written in place.  A decode
step reads its positions from the device (``DecodeCache.pos_t``,
``cross_pos_t``) and advances ``pos_t`` there, so the step holds no host
value and can be captured as a CUDA graph.

Under a sharding policy (``distributed.sharding.use_policy``) the
parameters, caches and activations are DTensors: ``constrain`` pins them
at the reference's points, ``init_cache`` allocates each rank's shards,
the cache writes go through ``distributed.local``, and serving runs under
``no_grad``; without one nothing of this runs.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import staterules
from repro_torch.distributed.local import (assign, gathered, matmul,
                                           write_prefix)
from repro_torch.distributed.sharding import constrain, get_policy
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import (FFN_DENSE, FFN_MOE, MIXER_ATTN,
                                       MIXER_MAMBA, MIXER_MLSTM, MIXER_SLSTM,
                                       BlockSpec, ModelConfig)

# Parameters that keep cfg.param_dtype (norm scales, and what the JAX
# package reads in float32); every other one is a matrix or bias, held in
# cfg.compute_dtype by a serving model and cast to it at its use by a
# training model.
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
    advances in place; and ``max_len``, the positions it holds.  An
    encoder-decoder model's cache also holds ``cross``, the encoder's K/V
    for each decoder layer (a ``KVCache`` a period position, (n_periods,
    B, T_enc, KV, Dh)), which prefill writes in place, and
    ``cross_pos_t``, a one-element int64 tensor holding T_enc - 1, the
    last encoder position cross attention reads, fixed for the cache."""
    blocks: Tuple[NamedTuple, ...]
    pos: int
    pos_t: torch.Tensor
    max_len: int
    cross: Optional[Tuple[NamedTuple, ...]] = None
    cross_pos_t: Optional[torch.Tensor] = None

    def zero_(self) -> None:
        """Zeroes every state, the cross K/V and pos_t in place."""
        for state in self.blocks + (self.cross or ()):
            for t in state:
                t.zero_()
        self.pos_t.zero_()


def _serving(fn):
    """Runs ``fn`` under ``torch.inference_mode``, or, under a sharding
    policy, under ``torch.no_grad``: a DTensor cannot be viewed as an
    inference tensor."""
    @functools.wraps(fn)
    def serving(*args, **kwargs):
        with (torch.no_grad() if get_policy() is not None
              else torch.inference_mode()):
            return fn(*args, **kwargs)
    return serving


# an encoder layer: attention (not causal) and a dense FFN
_ENC_SPEC = BlockSpec(mixer=MIXER_ATTN, ffn=FFN_DENSE)


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.sliding_window is not None:
        raise NotImplementedError(
            f"{cfg.name}: the torch Model has no sliding-window attention: "
            f"no config sets it, and the JAX package masks the window only "
            f"on its plain prefill path (see ROADMAP queue A, 'The rest of "
            f"the model zoo')")


def _has_norm2(cfg: ModelConfig, spec: BlockSpec) -> bool:
    return spec.ffn == FFN_MOE or (spec.ffn == FFN_DENSE and cfg.d_ff > 0)


def _init_block(cfg: ModelConfig, spec: BlockSpec, generator,
                cross: bool = False):
    dev = generator.device
    init_mixer = {MIXER_ATTN: attn.init_attention, MIXER_MAMBA: ssm.init_mamba,
                  MIXER_MLSTM: ssm.init_mlstm, MIXER_SLSTM: ssm.init_slstm}
    p = {"norm1": L.init_rmsnorm(cfg, dev),
         spec.mixer: init_mixer[spec.mixer](cfg, generator)}
    if cross:
        p["cross_norm"] = L.init_rmsnorm(cfg, dev)
        p["cross_attn"] = attn.init_attention(cfg, generator, cross=True)
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

    def items(self):
        return [*self._parameters.items(), *self._modules.items()]


def _cast(cfg: ModelConfig, tree) -> dict:
    """A block's parameters as a training model's forward uses them:
    nested dicts, each matrix and bias cast to ``cfg.compute_dtype`` (a
    differentiable cast), the ``_PARAM_DTYPE`` ones as they are."""
    return {k: (_cast(cfg, v) if isinstance(v, nn.Module) else
                v if k in _PARAM_DTYPE else v.to(cfg.compute_dtype))
            for k, v in tree.items()}


def _block_module(cfg: ModelConfig, spec: BlockSpec,
                  cross: bool = False) -> nn.ModuleDict:
    m = {"norm1": nn.ParameterDict(), spec.mixer: nn.ParameterDict()}
    if cross:
        m["cross_norm"] = nn.ParameterDict()
        m["cross_attn"] = nn.ParameterDict()
    if _has_norm2(cfg, spec):
        m["norm2"] = nn.ParameterDict()
        if spec.ffn == FFN_MOE:
            m["moe"] = _ParamTree(experts=nn.ParameterDict())
        else:
            m["mlp"] = nn.ParameterDict()
    return nn.ModuleDict(m)


def _residuals(cfg, spec, block, x, out, next_norm, memory=None, pos=None):
    """The rest of a block after its mixer output ``out``: with
    ``memory`` (the encoder's K/V of this layer), the residual add fused
    with ``cross_norm`` and cross attention (``attend_cross`` at ``pos``);
    the residual add fused with ``norm2``, the FFN, and its add fused with
    ``next_norm``; without an FFN the last add is fused with
    ``next_norm``.  Returns (x, next_norm(x), the MoE block's aux loss or
    None); the reference's prefill and decode drop the aux loss, its
    ``train_loss`` adds it."""
    aux = None
    if memory is not None:
        x, hc = L.add_rmsnorm(x, out, block["cross_norm"], cfg.norm_eps)
        out = attn.attend_cross(cfg, block["cross_attn"], hc, memory, pos)
    if "norm2" in block:
        x, h2 = L.add_rmsnorm(x, out, block["norm2"], cfg.norm_eps)
        if spec.ffn == FFN_MOE:
            out, aux = moe_mod.moe_ffn(cfg, block["moe"], h2)
        else:
            out = L.mlp(cfg, block["mlp"], h2)
    return (*L.add_rmsnorm(x, out, next_norm, cfg.norm_eps), aux)


def _block_end(x, h):
    """The reference's ``constrain(x, "act_btd")`` at the end of a block
    of a full pass, on both outputs of the fused add and norm: the
    residual stream and the next block's normed input."""
    return constrain(x, "act_btd"), constrain(h, "act_btd")


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


def init_params(cfg: ModelConfig, generator, train: bool = False
                ) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from ``generator`` on its device, named as
    ``Model.load`` takes them; with ``train``, each matrix drawn in
    ``cfg.param_dtype``."""
    dev = generator.device
    if train:  # matrices drawn in the parameter dtype
        cfg = dataclasses.replace(cfg, compute_dtype=cfg.param_dtype)
    params = flatten_params("embed", L.init_embeddings(cfg, generator))
    params.update(flatten_params("final_norm", L.init_rmsnorm(cfg, dev)))
    for p in range(cfg.n_periods):
        for i, spec in enumerate(cfg.period):
            params.update(flatten_params(
                f"blocks.{p}.{i}",
                _init_block(cfg, spec, generator, cross=cfg.is_encdec)))
    if cfg.is_encdec:
        for n in range(cfg.n_encoder_layers):
            params.update(flatten_params(
                f"enc_blocks.{n}", _init_block(cfg, _ENC_SPEC, generator)))
        params.update(flatten_params("enc_norm", L.init_rmsnorm(cfg, dev)))
    if cfg.frontend == "vision":
        params["vis_proj"] = L.dense_init(
            generator, (cfg.d_model, cfg.d_model), cfg.compute_dtype)
    return params


def param_structs(cfg: ModelConfig, train: bool = False
                  ) -> Dict[str, torch.Tensor]:
    """Every parameter as ``Model.init`` holds it, shape and dtype only:
    meta tensors, nothing drawn or allocated (the reference's
    ``jax.eval_shape(model.init, key)``)."""
    params = init_params(cfg, L.SHAPE_ONLY, train)
    return {name: t.to(param_dtype(cfg, name, train))
            for name, t in params.items()}


def param_dtype(cfg: ModelConfig, name: str, train: bool) -> torch.dtype:
    """The dtype ``Model.load`` holds parameter ``name`` in."""
    key = name.rpartition(".")[2]
    return (cfg.param_dtype if train or key in _PARAM_DTYPE
            else cfg.compute_dtype)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               filled: Optional[int], device) -> DecodeCache:
    """Zeroed states for ``batch`` sequences of ``max_len`` positions on
    ``device`` (``Model.init_cache``; "meta" for its shapes alone)."""
    blocks = tuple(_state_zeros(cfg, spec, batch, max_len, device)
                   for spec in cfg.period)
    pos = filled or 0
    cross = cross_pos_t = None
    if cfg.is_encdec:
        cross = tuple(_state_zeros(cfg, _ENC_SPEC, batch, cfg.encoder_seq,
                                   device) for _ in cfg.period)
        cross_pos_t = torch.full((1,), cfg.encoder_seq - 1,
                                 dtype=torch.int64, device=device)
    return DecodeCache(blocks=blocks, pos=pos, pos_t=torch.full(
        (1,), pos, dtype=torch.int64, device=device), max_len=max_len,
        cross=cross, cross_pos_t=cross_pos_t)


class Model(nn.Module):
    """The model.  ``Model(cfg)`` holds no tensors until
    ``init(generator)`` draws them or ``load(params)`` takes them; the model
    then lives on that device.  ``remat=True`` recomputes each period's
    activations in the backward of ``train_loss`` instead of keeping them
    (``torch.utils.checkpoint``, as the reference wraps each period in
    ``jax.checkpoint``)."""

    def __init__(self, cfg: ModelConfig, remat: bool = False):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.remat = remat
        self.trainable = False
        self.embed = nn.ParameterDict()
        self.final_norm = nn.ParameterDict()
        self.blocks = nn.ModuleList(
            nn.ModuleList(_block_module(cfg, spec, cross=cfg.is_encdec)
                          for spec in cfg.period)
            for _ in range(cfg.n_periods))
        if cfg.is_encdec:
            self.enc_blocks = nn.ModuleList(
                _block_module(cfg, _ENC_SPEC)
                for _ in range(cfg.n_encoder_layers))
            self.enc_norm = nn.ParameterDict()
        if cfg.frontend == "vision":
            self.register_parameter("vis_proj", None)

    @property
    def device(self) -> torch.device:
        return self.embed["tok_embed"].device

    @property
    def n_prefix(self) -> int:
        """Positions a prompt takes before its tokens: the vision stub's
        patches, which prefill puts first."""
        return self.cfg.n_patches if self.cfg.frontend == "vision" else 0

    # -- parameters ----------------------------------------------------------
    def init(self, generator: torch.Generator, train: bool = False) -> "Model":
        """Draws every parameter from ``generator``, on its device; with
        ``train``, in ``cfg.param_dtype`` (``load(..., train=True)``)."""
        return self.load(init_params(self.cfg, generator, train), train=train)

    def load(self, params: Dict[str, torch.Tensor],
             train: bool = False) -> "Model":
        """Takes parameters named ``<module path>.<key>`` (as ``init`` and
        ``repro_torch.weights.params_from_jax`` make them; ``vis_proj``
        has no path).  Serving: each matrix cast to ``cfg.compute_dtype``
        once, no gradient.  ``train``: every parameter in
        ``cfg.param_dtype`` with ``requires_grad`` (a float32 tensor is
        taken as it is, sharing its storage), each matrix cast at its use."""
        for name, t in params.items():
            path, _, key = name.rpartition(".")
            dtype = param_dtype(self.cfg, name, train)
            param = nn.Parameter(t.detach().to(dtype), requires_grad=train)
            if path:
                self.get_submodule(path)[key] = param
            else:
                setattr(self, key, param)
        self.trainable = train
        return self

    def _params(self, block):
        """A block's parameters as its forward reads them: cast at use in
        a training model, the held tensors in a serving one."""
        return _cast(self.cfg, block) if self.trainable else block

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
        """Zeroed states for ``batch`` sequences of ``max_len`` positions,
        ``filled`` of them taken; an encoder-decoder model's cross K/V
        hold ``cfg.encoder_seq`` positions.  Under a sharding policy the
        states are DTensors at ``staterules.decode_cache_shardings``, each
        rank holding its shards."""
        policy = get_policy()
        if policy is None:
            return init_cache(self.cfg, batch, max_len, filled, self.device)
        return staterules.sharded_zeros(
            policy, init_cache(self.cfg, batch, max_len, filled, "meta"))

    @_serving
    def encode(self, frames):
        """The encoder stack over ``frames`` (B, T, D): attention not
        causal, RoPE over 0..T-1, as the JAX package's ``encode``; returns
        ``enc_norm`` of its output."""
        return self._encode(frames)

    def _encode(self, frames):
        """``encode``'s body, which ``train_loss`` differentiates."""
        cfg = self.cfg
        x = frames.to(cfg.compute_dtype)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h = L.rmsnorm(x, self.enc_blocks[0]["norm1"], cfg.norm_eps)
        after = [block["norm1"] for block in self.enc_blocks[1:]]
        for block, norm in zip(self.enc_blocks, after + [self.enc_norm]):
            bp = self._params(block)
            out, _ = attn.attend_full(cfg, bp["attn"], h, positions,
                                      causal=False)
            x, h, _ = _residuals(cfg, _ENC_SPEC, bp, x, out, norm)
            x, h = _block_end(x, h)
        return h

    def _cross_kv(self, enc_out, cache: DecodeCache) -> None:
        """Each decoder layer's cross K/V of the encoder output, written
        into ``cache.cross`` in place."""
        for p, i, _, block, _ in self._layers():
            k, v = attn._project_kv(self.cfg,
                                    self._params(block)["cross_attn"], enc_out)
            assign(cache.cross[i].k[p], k)
            assign(cache.cross[i].v[p], v)

    @staticmethod
    def _memory(cache: DecodeCache, p: int, i: int):
        """Decoder layer (p, i)'s encoder K/V in the cache, as views; None
        without an encoder."""
        if cache.cross is None:
            return None
        return attn.KVCache(k=cache.cross[i].k[p], v=cache.cross[i].v[p])

    @_serving
    def prefill(self, tokens, max_len: Optional[int] = None,
                cache: Optional[DecodeCache] = None, *, frames=None,
                patches=None):
        """Run the prompt ``tokens`` (B, S); returns (last-token logits
        (B, 1, padded_vocab), DecodeCache).  An encoder-decoder model
        takes ``frames`` (B, cfg.encoder_seq, D), which the encoder runs
        over first; a vision model ``patches`` (B, n_patches, D),
        projected and put before the tokens.

        KV caches are written into zeroed buffers so decode can continue
        in place: ``max_len`` positions (default S), or the whole sequence
        where the patches make it longer, as the JAX package pads; each
        recurrent block's state is the one after the prompt, from zeros;
        ``cache`` given, it is that cache's buffers (zeroed first: nothing
        of an earlier prompt carries over), its ``pos_t`` is set to the
        sequence's length and its cross K/V written, in place."""
        cfg = self.cfg
        if cfg.is_encdec and frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder model: "
                             f"prefill needs frames (B, encoder_seq, d_model)")
        if cfg.frontend == "vision" and patches is None:
            raise ValueError(f"{cfg.name} has a vision frontend: prefill "
                             f"needs patches (B, n_patches, d_model)")
        if cfg.is_encdec and frames.shape[1] != cfg.encoder_seq:
            raise ValueError(f"{cfg.name} takes {cfg.encoder_seq} encoder "
                             f"frames, not {frames.shape[1]}")
        b, s_text = tokens.shape
        s = s_text + (patches.shape[1] if cfg.frontend == "vision" else 0)
        if cache is None:
            max_len = max_len or s_text
            if max_len < s_text:
                raise ValueError(f"max_len {max_len} < prompt length "
                                 f"{s_text}")
            cache = self.init_cache(b, max(max_len, s), filled=s)
        else:
            if (cache.blocks[0][0].shape[1] != b or cache.max_len < s
                    or max_len not in (None, cache.max_len)):
                raise ValueError(
                    f"a cache of {cache.blocks[0][0].shape[1]} sequences of "
                    f"{cache.max_len} positions cannot take {b} prompts of "
                    f"{s} positions")
            cache.zero_()
            cache.pos_t.fill_(s)
            cache = cache._replace(pos=s)
        x = L.embed(cfg, self.embed, tokens)
        if cfg.frontend == "vision":
            x = torch.cat([gathered(self._vision(patches), (1,)),
                           gathered(x, (1,))], dim=1)
        x = constrain(x, "act_btd")
        if cfg.is_encdec:
            self._cross_kv(self.encode(frames), cache)
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        positions = torch.arange(s, device=x.device)[None, :]
        for p, i, spec, block, norm in self._layers():
            block = self._params(block)
            params, dst = block[spec.mixer], cache.blocks[i]
            if spec.mixer == MIXER_ATTN:
                out, kv = attn.attend_full(cfg, params, h, positions)
                write_prefix(dst.k[p], kv.k)
                write_prefix(dst.v[p], kv.v)
            else:
                out, state = _FULL[spec.mixer](cfg, params, h)
                for t, new in zip(dst, state):
                    assign(t[p], new)
            x, h, _ = _residuals(cfg, spec, block, x, out, norm,
                                 self._memory(cache, p, i))
            x, h = _block_end(x, h)
        return L.lm_logits(cfg, self.embed, gathered(h, (1,))[:, -1:]), cache

    @_serving
    def decode_step(self, cache: DecodeCache, tokens):
        """tokens: (B, 1) the token sampled at position cache.pos_t - 1;
        returns logits for position cache.pos_t and the cache, updated in
        place: K/V written at pos_t, each recurrent state replaced by the
        next, then pos_t advanced by one.  Cross attention reads the
        encoder K/V up to ``cache.cross_pos_t``.  Only the bounds check
        reads the host's ``cache.pos``."""
        cfg = self.cfg
        pos = cache.pos
        if pos >= cache.max_len:
            raise ValueError(f"decode position {pos} is past the cache")
        x = L.embed(cfg, self.embed, tokens)
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        for p, i, spec, block, norm in self._layers():
            block = self._params(block)
            params = block[spec.mixer]
            state = type(cache.blocks[i])(*(t[p] for t in cache.blocks[i]))
            if spec.mixer == MIXER_ATTN:
                out, _ = attn.attend_decode(cfg, params, h, state,
                                            cache.pos_t)
            else:
                out, new = _DECODE[spec.mixer](cfg, params, h, state)
                for t, n in zip(state, new):
                    assign(t, n)
            x, h, _ = _residuals(cfg, spec, block, x, out, norm,
                                 self._memory(cache, p, i), cache.cross_pos_t)
        logits = constrain(L.lm_logits(cfg, self.embed, h), "logits")
        cache.pos_t.add_(1)
        return logits, cache._replace(pos=pos + 1)

    # -- training ------------------------------------------------------------
    def _vision(self, patches):
        """The vision stub: the patches projected by ``vis_proj``."""
        dtype = self.cfg.compute_dtype
        return matmul(patches.to(dtype), self.vis_proj.to(dtype))

    def _train_period(self, layers, positions, x, h, aux, enc):
        """The blocks of one period over the whole sequence: (x, h, aux)
        after them, ``h`` the norm after the period (the next block's
        norm1, or the final norm), ``aux`` with each MoE block's aux loss
        added.  ``enc``: the encoder's output, whose K/V each decoder
        layer projects for its cross attention."""
        cfg = self.cfg
        for _, _, spec, block, norm in layers:
            bp = self._params(block)
            if spec.mixer == MIXER_ATTN:
                out, _ = attn.attend_full(cfg, bp["attn"], h, positions)
            else:
                out, _ = _FULL[spec.mixer](cfg, bp[spec.mixer], h)
            memory = (None if enc is None else attn.KVCache(
                *attn._project_kv(cfg, bp["cross_attn"], enc)))
            x, h, a = _residuals(cfg, spec, bp, x, out, norm, memory)
            x, h = _block_end(x, h)
            if a is not None:
                aux = aux + a
        return x, h, aux

    def train_loss(self, batch: Dict[str, torch.Tensor]):
        """The reference's ``train_loss``: ``batch`` holds 'tokens' and
        'labels' (B, S) on the model's device, and 'frames' (B,
        encoder_seq, D) for an encoder-decoder model or 'patches' (B,
        n_patches, D) for the vision stub.  The mean next-token CE over
        the text positions (labels past the vocabulary masked), plus
        ``0.01 * aux / n_layers`` with MoE blocks.  The blocks run in
        prefill's fused order; ``remat`` recomputes each period in the
        backward."""
        cfg = self.cfg
        x = L.embed(cfg, self.embed, batch["tokens"])
        enc = self._encode(batch["frames"]) if cfg.is_encdec else None
        if cfg.frontend == "vision":
            x = torch.cat([gathered(self._vision(batch["patches"]), (1,)),
                           gathered(x, (1,))], dim=1)
        x = constrain(x, "act_btd")
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        h = L.rmsnorm(x, self.blocks[0][0]["norm1"], cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        layers, per = self._layers(), len(cfg.period)
        for p in range(cfg.n_periods):
            period = functools.partial(self._train_period,
                                       layers[p * per:(p + 1) * per],
                                       positions)
            if self.remat:
                x, h, aux = checkpoint(period, x, h, aux, enc,
                                       use_reentrant=False)
            else:
                x, h, aux = period(x, h, aux, enc)
        if cfg.frontend == "vision":
            h = gathered(h, (1,))[:, batch["patches"].shape[1]:]
        logits = constrain(L.lm_logits(cfg, self.embed, h), "logits")
        loss = L.cross_entropy(logits, batch["labels"], cfg.vocab_size)
        if any(b.ffn == FFN_MOE for b in cfg.period):
            loss = loss + 0.01 * aux / cfg.n_layers
        return loss
