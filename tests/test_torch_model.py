"""The torch model against the JAX model: configs, attention, and the
llama3.1-8b smoke model's prefill logits, KV caches and decode logits, with
the JAX weights converted through ``params_from_jax``; the MoE and
recurrent smoke models (phi3.5-moe, llama4-maverick, xlstm, jamba) in fp32,
their recurrent states included.  (whisper's and internvl2's smoke models
against JAX: ``test_torch_encdec.py``; here their parameter names, fused
norms and norm counts.)

fp32 compute is held at 1e-4: both sides run the same math and only the
summation order differs.  bf16 compute cannot be held at 2e-2: rounding the
hidden states to bf16 moves every logit by up to 2e-2 to 3.5e-2 from the
fp32 logits in either package (the JAX model also rounds scores and
probabilities to bf16 where the kernels keep fp32), so the two bf16 paths
differ by up to about 3e-2.  The bf16 test bounds that difference at 5e-2
and holds the port's bf16 error to the size of JAX's own."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as jax_archs
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import attention as tattn
from repro_torch.models import io as tio
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

ARCH = "llama3.1-8b"
PORTED = ("llama3.1-8b", "llama3.2-3b", "qwen2.5-32b", "command-r-35b",
          "qwen3-0.6b", "phi3.5-moe-42b-a6.6b", "llama4-maverick-400b-a17b",
          "xlstm-125m", "jamba-1.5-large-398b", "whisper-medium",
          "internvl2-1b")
NOT_PORTED = ()
# the smoke models of the MoE and recurrent blocks, with a prompt length
# their chunked scans take (Mamba's chunk is 16)
MOE_AND_RECURRENT = {"phi3.5-moe-42b-a6.6b": 12,
                     "llama4-maverick-400b-a17b": 12, "xlstm-125m": 12,
                     "jamba-1.5-large-398b": 16}
B, S, N_DECODE = 2, 12, 4
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(dtype_name, arch=ARCH):
    """The smoke config in both packages, JAX params and the torch model
    holding the same weights.  QKV biases and QK-norm scales, which init
    sets to 0 and 1, are drawn at random so that they count."""
    jdt, tdt = _DTYPES[dtype_name]
    jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jdt)
    tcfg = get_smoke_config(arch).scaled(compute_dtype=tdt)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(9)
    for block in params["blocks"]:
        for name, base in (("bq", 0.0), ("bk", 0.0), ("bv", 0.0),
                           ("q_norm", 1.0), ("k_norm", 1.0)):
            if name in block.get("attn", {}):
                a = block["attn"][name]
                block["attn"][name] = jnp.asarray(
                    base + 0.1 * rng.standard_normal(a.shape), a.dtype)
    tree = jax.tree.map(np.asarray, params)
    tmodel = Model(tcfg).load(params_from_jax(tree, tcfg, "cpu"))
    return jmodel, params, tmodel


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


# ------------------------------------------------------------------ configs --
@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_copies_every_field(which, arch):
    jcfg = (jax_get_config if which == "full" else jax_get_smoke_config)(arch)
    tcfg = (get_config if which == "full" else get_smoke_config)(arch)
    jf = {f.name for f in dataclasses.fields(jcfg)}
    assert jf == {f.name for f in dataclasses.fields(tcfg)}
    for name in jf - {"param_dtype", "compute_dtype", "period"}:
        assert getattr(jcfg, name) == getattr(tcfg, name), name
    assert [(b.mixer, b.ffn) for b in jcfg.period] == \
        [(b.mixer, b.ffn) for b in tcfg.period]
    assert tcfg.param_dtype == torch.float32
    assert tcfg.compute_dtype == torch.bfloat16
    for prop in ("padded_vocab", "n_periods", "param_count"):
        jv, tv = getattr(jcfg, prop), getattr(tcfg, prop)
        assert (jv() if callable(jv) else jv) == (tv() if callable(tv) else tv)


def test_other_archs_are_not_ported_yet():
    assert ARCHS == PORTED
    for arch in NOT_PORTED:
        with pytest.raises(KeyError, match="not ported"):
            get_config(arch)
    assert set(jax_archs) == set(PORTED) | set(NOT_PORTED)
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-2")


@pytest.mark.parametrize("path", [dict(sliding_window=64)],
                         ids=["sliding-window"])
def test_model_refuses_blocks_it_does_not_run(path):
    """Every block kind, the encoder-decoder path and the vision frontend
    run; sliding-window attention, which no config sets, is refused,
    naming ROADMAP."""
    cfg = get_smoke_config(ARCH).scaled(**path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model(cfg)


# ------------------------------------------------------------------- layers --
def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(5)[None, :] + 700
    np.testing.assert_allclose(
        _np(tlayers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                               500_000.0)),
        _np(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tlayers.rmsnorm(torch.from_numpy(x),
                            {"scale": torch.from_numpy(scale)})),
        _np(jlayers.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)})),
        rtol=2e-5, atol=2e-5)


def test_dense_init_is_truncated_fan_in_normal():
    t = tlayers.dense_init(torch.Generator().manual_seed(0), (400, 300),
                           torch.float32)
    std = 1.0 / 400 ** 0.5
    assert t.abs().max() <= 2 * std + 1e-7
    # truncated at 2 sigma the std shrinks to 0.8796 sigma
    assert abs(t.std().item() / std - 0.8796) < 0.01


# ---------------------------------------------------------------- attention --
@pytest.mark.parametrize("variant", [{}, {"qkv_bias": True, "qk_norm": True}])
def test_attention_matches_jax(variant):
    jcfg = jax_get_smoke_config(ARCH).scaled(compute_dtype=jnp.float32,
                                             **variant)
    tcfg = get_smoke_config(ARCH).scaled(compute_dtype=torch.float32,
                                         **variant)
    p = jattn.init_attention(jcfg, jax.random.key(3))
    if variant:  # non-trivial biases and norm scales
        ks = jax.random.split(jax.random.key(4), 5)
        p.update({n: jax.random.normal(k, p[n].shape) for n, k in
                  zip(("bq", "bk", "bv", "q_norm", "k_norm"), ks)})
    tp = {n: torch.from_numpy(np.array(a)) for n, a in p.items()}
    x = np.random.default_rng(5).standard_normal((B, S, jcfg.d_model))
    x = x.astype(np.float32)
    positions = np.arange(S)[None, :]
    jout, jkv = jattn.attend_full(jcfg, p, jnp.asarray(x), jnp.asarray(positions))
    tout, tkv = tattn.attend_full(tcfg, tp, torch.from_numpy(x),
                                  torch.from_numpy(positions))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    np.testing.assert_allclose(_np(tkv.k), _np(jkv.k), **tol)
    np.testing.assert_allclose(_np(tkv.v), _np(jkv.v), **tol)

    # one decode step at pos = S against the prefilled cache
    t_max = S + 3
    jcache = jattn.KVCache(
        k=jnp.pad(jkv.k, ((0, 0), (0, t_max - S), (0, 0), (0, 0))),
        v=jnp.pad(jkv.v, ((0, 0), (0, t_max - S), (0, 0), (0, 0))))
    tcache = tattn.init_kv_cache(tcfg, B, t_max, "cpu")
    tcache.k[:, :S] = tkv.k
    tcache.v[:, :S] = tkv.v
    xd = x[:, :1] * 0.5
    jout, jcache = jattn.attend_decode(jcfg, p, jnp.asarray(xd), jcache, S)
    tout, tcache = tattn.attend_decode(tcfg, tp, torch.from_numpy(xd),
                                       tcache, S)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    np.testing.assert_allclose(_np(tcache.k), _np(jcache.k), **tol)


# -------------------------------------------------------------- whole model --
def _serve_both(dtype_name, arch=ARCH, S=S):
    """Prefill plus N_DECODE teacher-forced decode steps in both packages.
    Returns the logits of each step and the final decode states (KV
    caches and recurrent states), as numpy."""
    jmodel, params, tmodel = _pair(dtype_name, arch)
    cfg = tmodel.cfg
    toks = _tokens(1, (B, S), cfg.vocab_size)
    steps = _tokens(2, (N_DECODE, B, 1), cfg.vocab_size)
    max_len = S + N_DECODE

    jlogits, jcache = jax.jit(
        lambda p, t: jmodel.prefill(p, {"tokens": t}, max_len=max_len))(
        params, jnp.asarray(toks))
    tlogits, tcache = tmodel.prefill(torch.from_numpy(toks).long(), max_len)
    assert tlogits.shape == (B, 1, cfg.padded_vocab)
    assert tlogits.dtype == cfg.compute_dtype
    assert tcache.pos == int(jcache.pos) == S
    jl, tl = [_np(jlogits)], [_np(tlogits)]
    jstep = jax.jit(jmodel.decode_step)
    for tok in steps:
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tok))
        tlogits, tcache = tmodel.decode_step(tcache,
                                             torch.from_numpy(tok).long())
        jl.append(_np(jlogits))
        tl.append(_np(tlogits))
    assert tcache.pos == S + N_DECODE
    for jst, tst in zip(jcache.blocks, tcache.blocks):
        assert type(tst).__name__ == type(jst).__name__
        assert [tuple(t.shape) for t in tst] == [j.shape for j in jst]
    jkv = [_np(t) for kv in jcache.blocks for t in kv]
    tkv = [_np(t) for kv in tcache.blocks for t in kv]
    return (np.stack(jl), jkv), (np.stack(tl), tkv)


def test_prefill_and_decode_match_jax_fp32():
    (jl, jkv), (tl, tkv) = _serve_both("float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for j, t in zip(jkv, tkv):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "qwen2.5-32b"])
def test_other_dense_archs_match_jax_fp32(arch):
    """qwen3 (QK-norm, K1 over rows of one head; tied embeddings) and
    qwen2.5 (QKV bias) at smoke size, fp32 at 1e-4."""
    (jl, jkv), (tl, tkv) = _serve_both("float32", arch)
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for j, t in zip(jkv, tkv):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", list(MOE_AND_RECURRENT))
def test_moe_and_recurrent_archs_match_jax_fp32(arch):
    """phi3.5-moe (MoE top-2 every block), llama4-maverick (dense and MoE
    top-1 in turns), xlstm (sLSTM and mLSTM, no FFN, tied embeddings) and
    jamba (Mamba, attention at position 3, MoE at odd positions) at smoke
    size, fp32 at 1e-4: logits of prefill and every decode step, and
    every state (KV caches, Mamba's conv carry and SSM state, mLSTM's C
    and n, sLSTM's c, n and h)."""
    (jl, jst), (tl, tst) = _serve_both("float32", arch,
                                       S=MOE_AND_RECURRENT[arch])
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert len(jst) == len(tst)
    for j, t in zip(jst, tst):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


def test_prefill_and_decode_match_jax_bf16():
    """bf16 logits of the two packages agree within 5e-2, and the port's lie
    no farther from the fp32 logits than 1.5 times JAX's do.

    The measured gap is 2.9e-2, against the 2e-2 of the reference's own
    archs smoke test: JAX's ``_sdpa`` rounds scores and probabilities to
    bf16 where the port's kernels keep them in fp32.  A later tightening
    starts from that baseline."""
    (jl, jkv), (tl, tkv) = _serve_both("bfloat16")
    (fl, _), _ = _serve_both("float32")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-2)
    for j, t in zip(jkv, tkv):
        np.testing.assert_allclose(t, j, rtol=0, atol=5e-2)
    assert np.abs(tl - fl).max() <= 1.5 * np.abs(jl - fl).max()


def test_decode_matches_teacher_forced_prefill():
    """Decoding the last token must give the logits of prefilling it."""
    tmodel = Model(get_smoke_config(ARCH)).init(
        torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(3, (B, S), tmodel.cfg.vocab_size)).long()
    full, _ = tmodel.prefill(toks)
    _, cache = tmodel.prefill(toks[:, :-1], max_len=S)
    dec, _ = tmodel.decode_step(cache, toks[:, -1:])
    np.testing.assert_allclose(_np(dec), _np(full), rtol=0, atol=2e-2)


def test_cpu_path_leaves_launch_counters_at_zero():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    before = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches,
              da_ops.decode_attention.launches)
    tmodel = Model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(0))
    _, cache = tmodel.prefill(torch.zeros((1, 4), dtype=torch.long), 6)
    tmodel.decode_step(cache, torch.zeros((1, 1), dtype=torch.long))
    assert (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches,
            da_ops.decode_attention.launches) == before == (0, 0, 0)


# ------------------------------------------- fused norms, device position --
def _unfused(model, tokens, cache, pos=None, frames=None, patches=None):
    """The block order before the fused norms, written out: every residual
    add, then every norm, each alone.  ``pos`` None: a prefill into
    ``cache`` from position 0 (with ``frames``: the encoder first, each
    decoder layer's cross K/V of its output written into the cache; with
    ``patches``: projected and put before the tokens); else one decode
    step at the int ``pos``.  A decoder block with cross attention adds it
    between the mixer and the FFN.  Returns the last position's logits."""
    cfg = model.cfg
    eps = cfg.norm_eps
    x = tlayers.embed(cfg, model.embed, tokens)
    if patches is not None:
        vis = patches.to(cfg.compute_dtype) @ model.vis_proj
        x = torch.cat([vis, x], dim=1)
    if frames is not None:
        e = frames.to(cfg.compute_dtype)
        enc_pos = torch.arange(e.shape[1])[None, :]
        for block in model.enc_blocks:
            h = tlayers.rmsnorm(e, block["norm1"], eps)
            out, _ = tattn.attend_full(cfg, block["attn"], h, enc_pos,
                                       causal=False)
            e = e + out
            h2 = tlayers.rmsnorm(e, block["norm2"], eps)
            e = e + tlayers.mlp(cfg, block["mlp"], h2)
        e = tlayers.rmsnorm(e, model.enc_norm, eps)
        for p, period in enumerate(model.blocks):
            for i, block in enumerate(period):
                k, v = tattn._project_kv(cfg, block["cross_attn"], e)
                cache.cross[i].k[p] = k
                cache.cross[i].v[p] = v
    positions = torch.arange(x.shape[1])[None, :]
    for p, period in enumerate(model.blocks):
        for i, block in enumerate(period):
            h = tlayers.rmsnorm(x, block["norm1"], eps)
            if pos is None:
                out, kv = tattn.attend_full(cfg, block["attn"], h, positions)
                cache.blocks[i].k[p, :, :x.shape[1]] = kv.k
                cache.blocks[i].v[p, :, :x.shape[1]] = kv.v
            else:
                kv = tattn.KVCache(k=cache.blocks[i].k[p],
                                   v=cache.blocks[i].v[p])
                out, _ = tattn.attend_decode(cfg, block["attn"], h, kv, pos)
            x = x + out
            if "cross_attn" in block:
                mem = tattn.KVCache(k=cache.cross[i].k[p],
                                    v=cache.cross[i].v[p])
                last = (None if pos is None else
                        torch.tensor([mem.k.shape[1] - 1]))
                hc = tlayers.rmsnorm(x, block["cross_norm"], eps)
                x = x + tattn.attend_cross(cfg, block["cross_attn"], hc, mem,
                                           last)
            h2 = tlayers.rmsnorm(x, block["norm2"], eps)
            x = x + tlayers.mlp(cfg, block["mlp"], h2)
    x = tlayers.rmsnorm(x, model.final_norm, eps)
    return tlayers.lm_logits(cfg, model.embed, x[:, -1:])


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_model_is_the_unfused_block_order_bit_for_bit(dtype_name):
    """On the CPU the fused residual norms (``add_rmsnorm``) and the device
    position change no bit of the logits or the cache against the unfused
    block order, over a prefill and N_DECODE decode steps."""
    cfg = get_smoke_config(ARCH).scaled(compute_dtype=_DTYPES[dtype_name][1])
    model = Model(cfg).init(torch.Generator().manual_seed(4))
    toks = torch.from_numpy(_tokens(5, (B, S), cfg.vocab_size)).long()
    steps = torch.from_numpy(_tokens(6, (N_DECODE, B, 1), cfg.vocab_size))
    max_len = S + N_DECODE
    with torch.inference_mode():
        got, cache = model.prefill(toks, max_len)
        ref_cache = model.init_cache(B, max_len)
        want = _unfused(model, toks, ref_cache)
        assert torch.equal(got, want)
        for n, tok in enumerate(steps.long()):
            got, cache = model.decode_step(cache, tok)
            want = _unfused(model, tok, ref_cache, pos=S + n)
            assert torch.equal(got, want), n
    for kv, ref in zip(cache.blocks, ref_cache.blocks):
        assert torch.equal(kv.k, ref.k) and torch.equal(kv.v, ref.v)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_fused_encdec_and_vision_models_are_the_unfused_block_order(
        dtype_name, arch):
    """whisper's encoder and decoder blocks, whose three residual adds fuse
    with cross_norm, norm2 and the next norm1, and internvl2 with its
    patches first: on the CPU no bit of the logits, the self K/V or the
    cross K/V moves against the unfused block order, over a prefill and
    N_DECODE decode steps."""
    cfg = get_smoke_config(arch).scaled(compute_dtype=_DTYPES[dtype_name][1])
    model = Model(cfg).init(torch.Generator().manual_seed(4))
    seq = S + model.n_prefix
    extra = tio.make_batch(cfg, ShapeSpec("p", seq, B, "prefill"), seed=5)
    toks = extra.pop("tokens").long()
    steps = torch.from_numpy(_tokens(6, (N_DECODE, B, 1), cfg.vocab_size))
    max_len = seq + N_DECODE
    with torch.inference_mode():
        got, cache = model.prefill(toks, max_len, **extra)
        ref_cache = model.init_cache(B, max_len)
        want = _unfused(model, toks, ref_cache, **extra)
        assert torch.equal(got, want)
        for n, tok in enumerate(steps.long()):
            got, cache = model.decode_step(cache, tok)
            want = _unfused(model, tok, ref_cache, pos=seq + n)
            assert torch.equal(got, want), n
    states = cache.blocks + (cache.cross or ())
    refs = ref_cache.blocks + (ref_cache.cross or ())
    assert len(states) == (2 if cfg.is_encdec else 1)
    for st, ref in zip(states, refs):
        assert torch.equal(st.k, ref.k) and torch.equal(st.v, ref.v)


def test_forward_runs_one_plain_norm_and_the_rest_fused(monkeypatch):
    """64 fused norms and 1 plain norm a forward at llama3.1-8b's 32
    layers: 2 fused a block and the first block's norm1 alone, in prefill
    and decode alike."""
    calls = {"rmsnorm": 0, "add_rmsnorm": 0}
    for name in calls:
        fn = getattr(tlayers, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tlayers, name, counted)
    cfg = get_smoke_config(ARCH)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    _, cache = model.prefill(torch.zeros((1, 4), dtype=torch.long), 6)
    assert calls == {"rmsnorm": 1, "add_rmsnorm": 2 * cfg.n_layers}
    model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long))
    assert calls == {"rmsnorm": 2, "add_rmsnorm": 4 * cfg.n_layers}
    assert 2 * get_config(ARCH).n_layers + 1 == 65


def test_pos_t_follows_prefill_and_decode_steps():
    model = Model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(1))
    _, cache = model.prefill(torch.zeros((2, 5), dtype=torch.long), 9)
    assert cache.pos_t.dtype == torch.int64 and cache.pos_t.shape == (1,)
    assert cache.pos == int(cache.pos_t) == 5
    for n in range(1, 4):
        _, cache = model.decode_step(cache, torch.zeros((2, 1),
                                                        dtype=torch.long))
        assert cache.pos == int(cache.pos_t) == 5 + n


def test_host_position_never_reaches_the_arithmetic():
    """Two caches with the same pos_t and another host pos (both in
    bounds) give the same logits and caches: only the bounds check reads
    the host's pos."""
    model = Model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(2))
    toks = torch.from_numpy(_tokens(7, (B, S), model.cfg.vocab_size)).long()
    _, cache = model.prefill(toks, S + 6)
    other = cache._replace(
        blocks=tuple(tattn.KVCache(k=kv.k.clone(), v=kv.v.clone())
                     for kv in cache.blocks),
        pos=2, pos_t=cache.pos_t.clone())
    tok = toks[:, -1:]
    for _ in range(3):
        a, cache = model.decode_step(cache, tok)
        b, other = model.decode_step(other, tok)
        assert torch.equal(a, b)
    for x, y in zip(cache.blocks, other.blocks):
        assert torch.equal(x.k, y.k) and torch.equal(x.v, y.v)
    assert int(cache.pos_t) == int(other.pos_t) == S + 3 != other.pos


def test_prefill_fills_a_given_cache_in_place():
    """``prefill(cache=...)`` zeroes the given buffers (a stale slot past
    the prompt holds no old value), writes the prompt's K/V into them and
    sets pos_t in place: the same logits and cache as a fresh prefill."""
    model = Model(get_smoke_config(ARCH)).init(torch.Generator().manual_seed(3))
    toks = torch.from_numpy(_tokens(8, (B, S), model.cfg.vocab_size)).long()
    want, fresh = model.prefill(toks, S + 4)
    given = model.init_cache(B, S + 4, filled=S + 3)
    for kv in given.blocks:
        kv.k.fill_(float("nan"))
        kv.v.fill_(7.0)
    pos_t, ks = given.pos_t, [kv.k for kv in given.blocks]
    got, cache = model.prefill(toks, cache=given)
    assert torch.equal(got, want)
    assert cache.pos == S and cache.pos_t is pos_t and int(pos_t) == S
    for kv, ref, k in zip(cache.blocks, fresh.blocks, ks):
        assert kv.k is k and torch.equal(kv.k, ref.k)
        assert torch.equal(kv.v, ref.v)
    with pytest.raises(ValueError, match="cannot take"):
        model.prefill(toks[:1], cache=given)


# ---------------------------------------- MoE and recurrent blocks, model --
@pytest.mark.parametrize("arch", [*MOE_AND_RECURRENT, "whisper-medium",
                                  "internvl2-1b"])
def test_parameters_keep_the_jax_names_and_types(arch):
    """``named_parameters()`` are the JAX pytree's leaves, named as
    ``params_from_jax`` names them (``moe.router`` beside
    ``moe.experts.w_gate``; whisper's ``enc_blocks.<layer>.attn.wq``,
    ``enc_norm.scale``, ``blocks.<p>.<i>.cross_attn.wq`` and
    ``cross_norm``; internvl2's ``vis_proj``), with the same shapes; under
    bf16 compute the norm scales and Mamba's A_log, D and dt_bias stay
    float32."""
    jcfg = jax_get_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    params = JaxModel(jcfg).init(jax.random.key(0))
    want = params_from_jax(jax.tree.map(np.asarray, params), tcfg, "cpu")
    model = Model(tcfg).load(want)
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    fp32 = ("scale", "A_log", "D", "dt_bias")
    for name, t in got.items():
        assert t.shape == want[name].shape, name
        key = name.rpartition(".")[2]
        assert t.dtype == (torch.float32 if key in fp32
                           else torch.bfloat16), name
    drawn = Model(tcfg).init(torch.Generator().manual_seed(0))
    assert {n: t.shape for n, t in drawn.named_parameters()} == \
        {n: t.shape for n, t in got.items()}


@pytest.mark.parametrize("arch", ["xlstm-125m", "jamba-1.5-large-398b"])
def test_prefill_into_a_used_cache_starts_from_zero_states(arch):
    """A cache that served one prompt and some decode steps, filled again
    by ``prefill(cache=...)``: no state of the first prompt carries into
    the second; logits and every state equal a fresh prefill's."""
    cfg = get_smoke_config(arch)
    model = Model(cfg).init(torch.Generator().manual_seed(5))
    s = MOE_AND_RECURRENT[arch]
    first = torch.from_numpy(_tokens(9, (B, s), cfg.vocab_size)).long()
    second = torch.from_numpy(_tokens(10, (B, s), cfg.vocab_size)).long()
    _, cache = model.prefill(first, s + 4)
    for _ in range(3):
        _, cache = model.decode_step(cache, first[:, -1:])
    want, fresh = model.prefill(second, s + 4)
    got, cache = model.prefill(second, cache=cache)
    assert torch.equal(got, want)
    assert cache.pos == int(cache.pos_t) == s
    for st, ref in zip(cache.blocks, fresh.blocks):
        assert all(torch.equal(a, b) for a, b in zip(st, ref))
    tok = second[:, -1:]
    a, _ = model.decode_step(cache, tok)
    b, _ = model.decode_step(fresh, tok)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", list(MOE_AND_RECURRENT))
def test_norms_fuse_with_the_adds_of_every_block_kind(arch, monkeypatch):
    """One plain norm a forward; a block with an FFN (dense or MoE) runs
    two fused norms, one without (xlstm's) one: its mixer's add fused with
    the next block's norm1."""
    calls = {"rmsnorm": 0, "add_rmsnorm": 0}
    for name in calls:
        fn = getattr(tlayers, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tlayers, name, counted)
    cfg = get_smoke_config(arch)
    fused = sum(1 if cfg.d_ff == 0 and b.ffn != "moe" else 2
                for b in cfg.period) * cfg.n_periods
    assert fused == (cfg.n_layers if arch == "xlstm-125m"
                     else 2 * cfg.n_layers)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    s = MOE_AND_RECURRENT[arch]
    _, cache = model.prefill(torch.zeros((1, s), dtype=torch.long), s + 2)
    assert calls == {"rmsnorm": 1, "add_rmsnorm": fused}
    model.decode_step(cache, torch.zeros((1, 1), dtype=torch.long))
    assert calls == {"rmsnorm": 2, "add_rmsnorm": 2 * fused}


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_encdec_and_vision_norms_fuse_with_every_add(arch, monkeypatch):
    """whisper: the encoder's first norm1 alone and 2 fused norms an
    encoder layer (enc_norm last), then the decoder's first norm1 alone
    and 3 fused a decoder layer (cross_norm, norm2, the next norm1) in a
    prefill, the decoder's alone in a decode step; internvl2 as a dense
    model, its patches adding no norm."""
    calls = {"rmsnorm": 0, "add_rmsnorm": 0}
    for name in calls:
        fn = getattr(tlayers, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(tlayers, name, counted)
    cfg = get_smoke_config(arch)
    model = Model(cfg).init(torch.Generator().manual_seed(0))
    extra = tio.make_batch(cfg, ShapeSpec("p", 4 + model.n_prefix, 1,
                                          "prefill"), seed=0)
    toks = extra.pop("tokens").long()
    _, cache = model.prefill(toks, 6 + model.n_prefix, **extra)
    enc = cfg.n_encoder_layers
    step = (3 if cfg.is_encdec else 2) * cfg.n_layers
    assert calls == {"rmsnorm": 1 + (enc > 0), "add_rmsnorm": 2 * enc + step}
    model.decode_step(cache, toks[:, :1])
    assert calls == {"rmsnorm": 2 + (enc > 0),
                     "add_rmsnorm": 2 * enc + 2 * step}
