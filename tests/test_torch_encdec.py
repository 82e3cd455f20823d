"""whisper's encoder-decoder path and internvl2's vision frontend against
the JAX package: cross attention, the encoder, and both smoke models'
prefill and decode steps against the JAX ``Model.prefill`` +
``decode_step`` loop fed by ``io.make_batch`` (the reference's engine
serves tokens only, so its model is the oracle), with the JAX weights
converted through ``params_from_jax``.

fp32 is held at 1e-4 (1e-5 for one attention call): both sides run the
same math and only the summation order differs.  bf16 at 5e-2, as
``test_torch_model.py`` holds the dense model: JAX's ``_sdpa`` rounds
scores and probabilities to bf16 where the port's kernels keep fp32."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs.shapes import ShapeSpec as JaxShapeSpec
from repro.models import attention as jattn
from repro.models import io as jio
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import attention as tattn
from repro_torch.models import io as tio
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

WHISPER, INTERNVL = "whisper-medium", "internvl2-1b"
B, S, N_DECODE = 2, 12, 4
_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensor ops: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@functools.cache
def _pair(arch, dtype_name):
    """The smoke config in both packages, JAX params and the torch model
    holding the same weights (internvl2's QKV biases drawn at random, so
    that they count)."""
    jdt, tdt = _DTYPES[dtype_name]
    jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jdt)
    tcfg = get_smoke_config(arch).scaled(compute_dtype=tdt)
    jmodel = JaxModel(jcfg)
    params = jmodel.init(jax.random.key(0))
    rng = np.random.default_rng(9)
    for block in params["blocks"]:
        for name in ("bq", "bk", "bv"):
            if name in block["attn"]:
                a = block["attn"][name]
                block["attn"][name] = jnp.asarray(
                    0.1 * rng.standard_normal(a.shape), a.dtype)
    tree = jax.tree.map(np.asarray, params)
    return jmodel, params, Model(tcfg).load(params_from_jax(tree, tcfg, "cpu"))


def _batch(cfg_j, cfg_t, seed=3):
    """The same prefill batch from both packages' ``make_batch``: S text
    tokens, and the frames or patches."""
    seq = S + (cfg_t.n_patches if cfg_t.frontend == "vision" else 0)
    jb = jio.make_batch(cfg_j, JaxShapeSpec("p", seq, B, "prefill"), seed)
    tb = tio.make_batch(cfg_t, ShapeSpec("p", seq, B, "prefill"), seed)
    tokens = tb.pop("tokens").long()
    return jb, tokens, tb, seq


@functools.cache
def _serve_both(arch, dtype_name):
    """Prefill plus N_DECODE teacher-forced decode steps in both packages.
    Returns, for each side, the logits of each step, the self K/V and the
    cross K/V (none without an encoder), as numpy."""
    jmodel, params, tmodel = _pair(arch, dtype_name)
    jb, tokens, extra, seq = _batch(jmodel.cfg, tmodel.cfg)
    steps = np.random.default_rng(2).integers(
        0, tmodel.cfg.vocab_size, (N_DECODE, B, 1), dtype=np.int32)
    max_len = seq + N_DECODE
    jlogits, jcache = jax.jit(
        lambda p, b: jmodel.prefill(p, b, max_len=max_len))(params, jb)
    tlogits, tcache = tmodel.prefill(tokens, max_len, **extra)
    assert tlogits.shape == (B, 1, tmodel.cfg.padded_vocab)
    assert tcache.pos == int(tcache.pos_t) == int(jcache.pos) == seq
    assert tcache.max_len == max_len
    jl, tl = [_np(jlogits)], [_np(tlogits)]
    jstep = jax.jit(jmodel.decode_step)
    for tok in steps:
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tok))
        tlogits, tcache = tmodel.decode_step(tcache,
                                             torch.from_numpy(tok).long())
        jl.append(_np(jlogits))
        tl.append(_np(tlogits))
    out = []
    for cache in (jcache, tcache):
        kv = [_np(t) for st in cache.blocks for t in st]
        cross = [_np(t) for st in (cache.cross or ()) for t in st]
        out.append((kv, cross))
    (jkv, jcross), (tkv, tcross) = out
    assert [a.shape for a in tkv] == [a.shape for a in jkv]
    assert [a.shape for a in tcross] == [a.shape for a in jcross]
    return (np.stack(jl), jkv, jcross), (np.stack(tl), tkv, tcross)


# ------------------------------------------------------- cross attention --
@pytest.mark.parametrize("kv_heads", [4, 2], ids=["G1", "G2"])
def test_attend_cross_matches_jax(kv_heads):
    """Cross attention over a prompt (K2, not causal, its own key length
    T) and in a decode step (K3 over all T, its position a device
    tensor), against the JAX ``attend_cross``; no RoPE, fp32 at 1e-5."""
    jcfg = jax_get_smoke_config(WHISPER).scaled(compute_dtype=jnp.float32,
                                                n_kv_heads=kv_heads)
    tcfg = get_smoke_config(WHISPER).scaled(compute_dtype=torch.float32,
                                            n_kv_heads=kv_heads)
    p = jattn.init_attention(jcfg, jax.random.key(3), cross=True)
    tp = {n: torch.from_numpy(np.array(a)) for n, a in p.items()}
    rng = np.random.default_rng(5)
    t = jcfg.encoder_seq
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, t, jcfg.d_model)).astype(np.float32)
    jk, jv = jattn._project_kv(jcfg, p, jnp.asarray(mem))
    tk, tv = tattn._project_kv(tcfg, tp, torch.from_numpy(mem))
    np.testing.assert_allclose(_np(tk), _np(jk), rtol=1e-5, atol=1e-5)
    jmem, tmem = jattn.KVCache(k=jk, v=jv), tattn.KVCache(k=tk, v=tv)
    tol = dict(rtol=1e-5, atol=1e-5)
    want = jattn.attend_cross(jcfg, p, jnp.asarray(x), jmem)
    np.testing.assert_allclose(
        _np(tattn.attend_cross(tcfg, tp, torch.from_numpy(x), tmem)),
        _np(want), **tol)
    last = torch.tensor([t - 1])
    np.testing.assert_allclose(
        _np(tattn.attend_cross(tcfg, tp, torch.from_numpy(x[:, :1]), tmem,
                               last)),
        _np(want[:, :1]), **tol)


def test_cross_attention_has_no_qkv_bias():
    """A config with QKV bias keeps it out of cross attention, in both
    packages."""
    jcfg = jax_get_smoke_config(INTERNVL)
    tcfg = get_smoke_config(INTERNVL)
    for cross in (False, True):
        want = set(jattn.init_attention(jcfg, jax.random.key(0), cross=cross))
        got = set(tattn.init_attention(tcfg, torch.Generator().manual_seed(0),
                                       cross=cross))
        assert got == want
        assert ("bq" in got) == (not cross)


# ---------------------------------------------------------------- encoder --
def test_encode_matches_jax():
    """The encoder stack over make_batch's frames: non-causal K2 at the
    smoke model's 32 frames, RoPE over 0..31, the fused residual norms,
    ``enc_norm`` last; fp32 at 1e-4."""
    jmodel, params, tmodel = _pair(WHISPER, "float32")
    jb, _, extra, _ = _batch(jmodel.cfg, tmodel.cfg)
    want = jax.jit(jmodel.encode)(params, jb["frames"])
    got = tmodel.encode(extra["frames"])
    assert got.shape == (B, tmodel.cfg.encoder_seq, tmodel.cfg.d_model)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------ whole model --
@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_smoke_models_match_the_jax_loop_fp32(arch):
    """Prefill logits and N_DECODE decode steps' logits, the self K/V (the
    patches' positions first for internvl2) and whisper's cross K/V, fp32
    at 1e-4."""
    (jl, jkv, jcross), (tl, tkv, tcross) = _serve_both(arch, "float32")
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=1e-4)
    assert len(tcross) == (2 if arch == WHISPER else 0)
    for j, t in zip(jkv + jcross, tkv + tcross):
        np.testing.assert_allclose(t, j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", [WHISPER, INTERNVL])
def test_smoke_models_match_the_jax_loop_bf16(arch):
    """In bf16 the two packages' logits and caches agree within 5e-2, and
    the port's logits lie no farther from the fp32 ones than 1.5 times
    JAX's do."""
    (jl, jkv, jcross), (tl, tkv, tcross) = _serve_both(arch, "bfloat16")
    (fl, _, _), _ = _serve_both(arch, "float32")
    np.testing.assert_allclose(tl, jl, rtol=0, atol=5e-2)
    for j, t in zip(jkv + jcross, tkv + tcross):
        np.testing.assert_allclose(t, j, rtol=0, atol=5e-2)
    assert np.abs(tl - fl).max() <= 1.5 * np.abs(jl - fl).max()


def test_prefill_needs_the_frontend_inputs():
    for arch, name in ((WHISPER, "frames"), (INTERNVL, "patches")):
        model = Model(get_smoke_config(arch)).init(
            torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match=name):
            model.prefill(torch.zeros((1, 4), dtype=torch.long), 8)


def test_a_used_cache_takes_new_frames():
    """A cache that served one request, filled again by
    ``prefill(cache=...)`` with other frames: its cross K/V are the new
    frames', in the same buffers, and every logit and state equals a
    fresh prefill's; frames of another length than the config's are
    refused."""
    _, _, model = _pair(WHISPER, "float32")
    cfg = model.cfg
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S))).long()
    shape = ShapeSpec("p", S, B, "prefill")
    first = tio.make_batch(cfg, shape, seed=4)["frames"]
    second = tio.make_batch(cfg, shape, seed=5)["frames"]
    _, cache = model.prefill(toks, S + 4, frames=first)
    for _ in range(2):
        _, cache = model.decode_step(cache, toks[:, -1:])
    ks = [kv.k for kv in cache.cross]
    want, fresh = model.prefill(toks, S + 4, frames=second)
    got, cache = model.prefill(toks, cache=cache, frames=second)
    assert torch.equal(got, want)
    assert int(cache.cross_pos_t) == cfg.encoder_seq - 1
    for st, ref, k in zip(cache.blocks + cache.cross,
                          fresh.blocks + fresh.cross, ks + ks):
        assert all(torch.equal(a, b) for a, b in zip(st, ref))
    assert all(kv.k is k for kv, k in zip(cache.cross, ks))
    a, _ = model.decode_step(cache, toks[:, -1:])
    b, _ = model.decode_step(fresh, toks[:, -1:])
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="encoder frames"):
        model.prefill(toks, cache=cache, frames=second[:, :16])


def test_vision_cache_counts_the_patches():
    """internvl2's patches take the cache's first n_patches positions:
    the default cache holds them and the prompt, ``max_len`` counts them,
    and decode continues after both."""
    _, _, model = _pair(INTERNVL, "float32")
    cfg = model.cfg
    assert model.n_prefix == cfg.n_patches == 8
    toks = torch.zeros((B, S), dtype=torch.long)
    patches = tio.make_batch(cfg, ShapeSpec("p", S + 8, B, "prefill"),
                             seed=1)["patches"]
    _, cache = model.prefill(toks, patches=patches)
    assert cache.max_len == cache.pos == S + 8
    _, cache = model.prefill(toks, S + 8 + 3, patches=patches)
    assert cache.max_len == S + 11 and int(cache.pos_t) == S + 8
    for _ in range(3):
        _, cache = model.decode_step(cache, toks[:, :1])
    assert int(cache.pos_t) == S + 11
    with pytest.raises(ValueError, match="past the cache"):
        model.decode_step(cache, toks[:, :1])
