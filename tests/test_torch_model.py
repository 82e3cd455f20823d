"""The torch model against the JAX model: configs, attention, and the
llama3.1-8b smoke model's prefill logits, KV caches and decode logits, with
the JAX weights converted through ``params_from_jax``.

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

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models.config import FFN_MOE, MIXER_MAMBA, BlockSpec
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

ARCH = "llama3.1-8b"
B, S, N_DECODE = 2, 12, 4
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _pair(dtype_name):
    """The smoke config in both packages, JAX params and the torch model
    holding the same weights."""
    jdt, tdt = _DTYPES[dtype_name]
    jcfg = jax_get_smoke_config(ARCH).scaled(compute_dtype=jdt)
    tcfg = get_smoke_config(ARCH).scaled(compute_dtype=tdt)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tmodel = Model(tcfg).load(params_from_jax(tree, tcfg, "cpu"))
    return jmodel, params, tmodel


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape, dtype=np.int32)


# ------------------------------------------------------------------ configs --
@pytest.mark.parametrize("which", ["full", "smoke"])
def test_config_copies_every_field(which):
    jcfg = (jax_get_config if which == "full" else jax_get_smoke_config)(ARCH)
    tcfg = (get_config if which == "full" else get_smoke_config)(ARCH)
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
    with pytest.raises(KeyError, match="not ported"):
        get_config("qwen2.5-32b")
    with pytest.raises(KeyError, match="unknown"):
        get_config("gpt-2")


@pytest.mark.parametrize("period", [(BlockSpec(ffn=FFN_MOE),),
                                    (BlockSpec(mixer=MIXER_MAMBA),)])
def test_model_refuses_blocks_it_does_not_run(period):
    cfg = get_smoke_config(ARCH).scaled(period=period)
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
def _serve_both(dtype_name):
    """Prefill plus N_DECODE teacher-forced decode steps in both packages.
    Returns the logits of each step and the final KV caches, as numpy."""
    jmodel, params, tmodel = _pair(dtype_name)
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
    for jkv, tkv in zip(jcache.blocks, tcache.blocks):
        assert tuple(tkv.k.shape) == jkv.k.shape
    jkv = [_np(t) for kv in jcache.blocks for t in kv]
    tkv = [_np(t) for kv in tcache.blocks for t in kv]
    return (np.stack(jl), jkv), (np.stack(tl), tkv)


def test_prefill_and_decode_match_jax_fp32():
    (jl, jkv), (tl, tkv) = _serve_both("float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    for j, t in zip(jkv, tkv):
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
