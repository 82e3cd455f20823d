"""The backward of K1 (RMSNorm, plain and fused with the residual add) and
K2 (flash attention) on the CPU: the plain backward formulas of
``kernels/*/ref.py`` against ``jax.vjp`` of the reference's jnp twins
(``repro.models.layers.rmsnorm``, ``repro.models.attention._sdpa``) in
fp32 within 1e-5, and the ``torch.autograd.Function``s that the wrappers
become under grad mode against ``torch.autograd`` of the plain forwards.
The CUDA kernels themselves are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase [18])."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn
from repro.models import layers as jlayers

from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                             add_rmsnorm_ref, rmsnorm_bwd_ref,
                                             rmsnorm_ref)

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _jit_vjp(fn, primals, cotangent):
    """fn's cotangents for ``primals`` given ``cotangent``, jitted (eager
    JAX takes seconds a call here)."""
    return jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(primals, cotangent)


# ------------------------------------------------------------------ K1 ---
@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128), (3, 4, 16, 32)])
def test_rmsnorm_bwd_formula_matches_jax_grad(shape):
    rng = np.random.default_rng(0)
    x, dy = _rand(rng, *shape), _rand(rng, *shape)
    scale = _rand(rng, shape[-1])
    jdx, jds = _jit_vjp(lambda x, s: jlayers.rmsnorm(x, {"scale": s}),
                        (x, scale), dy)
    dx, dscale = rmsnorm_bwd_ref(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(dy))
    assert dscale.dtype == torch.float32
    np.testing.assert_allclose(_np(dx), _np(jdx), **TOL)
    np.testing.assert_allclose(_np(dscale), _np(jds), **TOL)


@pytest.mark.parametrize("shape", [(6, 64), (2, 5, 128)])
def test_add_rmsnorm_bwd_formula_matches_jax_grad(shape):
    """The fused entry's backward: x and r get the norm's dx at s = x + r
    plus ds, the gradient that reaches s through the residual stream."""
    rng = np.random.default_rng(1)
    x, r, dy, ds = (_rand(rng, *shape) for _ in range(4))
    scale = _rand(rng, shape[-1])

    def fused(x, r, s):
        t = x + r
        return t, jlayers.rmsnorm(t, {"scale": s})

    jdx, jdr, jds = _jit_vjp(fused, (x, r, scale), (ds, dy))
    s = torch.from_numpy(x) + torch.from_numpy(r)
    dx, dscale = add_rmsnorm_bwd_ref(s, torch.from_numpy(scale),
                                     torch.from_numpy(dy),
                                     torch.from_numpy(ds))
    np.testing.assert_allclose(_np(dx), _np(jdx), **TOL)
    np.testing.assert_allclose(_np(dx), _np(jdr), **TOL)
    np.testing.assert_allclose(_np(dscale), _np(jds), **TOL)


def _autograd_pair(fn, ref_fn, inputs, cotangents):
    """Gradients of ``fn`` (the wrapper) and of ``ref_fn`` (the plain
    forward, differentiated by torch.autograd) on copies of ``inputs``."""
    out = []
    for f in (fn, ref_fn):
        ins = [t.clone().requires_grad_() for t in inputs]
        res = f(*ins)
        res = res if isinstance(res, tuple) else (res,)
        torch.autograd.backward(
            [y for y, c in zip(res, cotangents) if c is not None],
            [c for c in cotangents if c is not None])
        out.append([t.grad for t in ins])
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_autograd_function_matches_torch_autograd(dtype):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(_rand(rng, 3, 7, 64)).to(dtype)
    scale = torch.from_numpy(_rand(rng, 64))
    dy = torch.from_numpy(_rand(rng, 3, 7, 64)).to(dtype)
    got, want = _autograd_pair(rms_ops.rmsnorm, rmsnorm_ref, (x, scale), (dy,))
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    assert rms_ops.rmsnorm_bwd.launches == 0


@pytest.mark.parametrize("with_ds", [True, False], ids=["ds", "no-ds"])
def test_add_rmsnorm_autograd_function_matches_torch_autograd(with_ds):
    """The fused norm's ds path, and the last block's, whose sum s only
    the final norm reads (its gradient None)."""
    rng = np.random.default_rng(3)
    x, r, dy, ds = (torch.from_numpy(_rand(rng, 4, 5, 32)) for _ in range(4))
    scale = torch.from_numpy(_rand(rng, 32))
    got, want = _autograd_pair(rms_ops.add_rmsnorm, add_rmsnorm_ref,
                               (x, r, scale), (ds if with_ds else None, dy))
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), **TOL)


def test_rmsnorm_bwd_wrapper_checks_shapes_and_counts_nothing_on_cpu():
    x = torch.ones(4, 8)
    with pytest.raises(ValueError, match="shapes"):
        rms_ops.rmsnorm_bwd(x, torch.ones(8), torch.ones(4, 7))
    with pytest.raises(ValueError, match="shapes"):
        rms_ops.rmsnorm_bwd(x, torch.ones(8), torch.ones(4, 8),
                            torch.ones(3, 8))
    rms_ops.rmsnorm_bwd(x, torch.ones(8), torch.ones(4, 8))
    assert rms_ops.rmsnorm_bwd.launches == 0


def test_serving_calls_save_nothing_for_backward():
    """Without grad mode, or without an input that wants a gradient, the
    wrappers run the forward alone: no autograd node."""
    x = torch.ones(2, 8, requires_grad=True)
    scale = torch.ones(8)
    with torch.inference_mode():
        assert rms_ops.rmsnorm(x, scale).grad_fn is None
    assert rms_ops.rmsnorm(x.detach(), scale).grad_fn is None
    assert rms_ops.rmsnorm(x, scale).grad_fn is not None
    q = torch.ones(1, 4, 2, 16)
    assert fa_ops.flash_attention(q, q, q).grad_fn is None
    assert fa_ops.flash_attention(q.requires_grad_(), q, q).grad_fn is not None


# ------------------------------------------------------------------ K2 ---
# (B, Sq, Sk, H, KV, Dh, causal): G 1 and > 1, Sk != Sq (cross attention,
# and a causal top-left mask over a longer or shorter key range)
CASES = [(2, 16, 16, 4, 4, 16, True), (2, 16, 16, 4, 2, 16, False),
         (1, 24, 24, 6, 2, 32, True), (2, 8, 20, 4, 1, 16, False),
         (1, 20, 12, 4, 2, 16, True), (1, 12, 20, 2, 1, 32, True)]


def _attn_inputs(seed, b, sq, sk, h, kv, dh):
    rng = np.random.default_rng(seed)
    return (_rand(rng, b, sq, h, dh), _rand(rng, b, sk, kv, dh),
            _rand(rng, b, sk, kv, dh), _rand(rng, b, sq, h, dh))


def _jax_attention(q, k, v, causal, scale):
    """The reference's train path: ``_sdpa`` over grouped heads, mask
    top-left causal; (B, Sq, H, Dh) in and out."""
    b, sq, h, dh = q.shape
    kv, sk = k.shape[2], k.shape[1]
    mask = None
    if causal:
        mask = (jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :])[
            None, None, None]
    out = jattn._sdpa(q.reshape(b, sq, kv, h // kv, dh), k, v, mask, scale)
    return out.reshape(b, sq, h, dh)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_attention_bwd_formula_matches_jax_grad(case):
    b, sq, sk, h, kv, dh, causal = case
    q, k, v, do = _attn_inputs(4, b, sq, sk, h, kv, dh)
    scale = dh ** -0.5

    def fn(q, k, v):
        return _jax_attention(q, k, v, causal, scale)

    jout = jax.jit(fn)(q, k, v)
    jgrads = _jit_vjp(fn, (q, k, v), do)
    hm = [torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)]
    out = attention_ref(*hm, causal=causal, scale=scale)
    np.testing.assert_allclose(_np(out.transpose(1, 2)), _np(jout), **TOL)
    grads = attention_bwd_ref(*hm, out, torch.from_numpy(do).transpose(1, 2),
                              causal=causal, scale=scale)
    for got, want in zip(grads, jgrads):
        np.testing.assert_allclose(_np(got.transpose(1, 2)), _np(want), **TOL)


@pytest.mark.parametrize("case", CASES[:3], ids=str)
def test_attention_lse_is_the_scores_logsumexp(case):
    b, sq, sk, h, kv, dh, causal = case
    q, k, v, _ = _attn_inputs(5, b, sq, sk, h, kv, dh)
    scale = dh ** -0.5
    hm = [torch.from_numpy(t).transpose(1, 2) for t in (q, k, v)]
    out, lse = attention_ref(*hm, causal=causal, scale=scale, return_lse=True)
    assert lse.shape == (b, h, sq) and lse.dtype == torch.float32
    qg = jnp.asarray(q).reshape(b, sq, kv, h // kv, dh)
    s = jnp.einsum("bqhgk,bshk->bhgqs", qg, jnp.asarray(k)) * scale
    if causal:
        s = jnp.where(jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :],
                      s, -1e30)
    want = jax.nn.logsumexp(s, axis=-1).reshape(b, h, sq)
    np.testing.assert_allclose(_np(lse), _np(want), **TOL)
    np.testing.assert_array_equal(_np(out), _np(attention_ref(
        *hm, causal=causal, scale=scale)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES[1::2], ids=str)
def test_flash_attention_autograd_function_matches_torch_autograd(case,
                                                                  dtype):
    b, sq, sk, h, kv, dh, causal = case
    q, k, v, do = (torch.from_numpy(t).to(dtype)
                   for t in _attn_inputs(6, b, sq, sk, h, kv, dh))

    def plain(q, k, v):
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal).transpose(1, 2)

    got, want = _autograd_pair(
        lambda q, k, v: fa_ops.flash_attention(q, k, v, causal=causal),
        plain, (q, k, v), (do,))
    tol = TOL if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == dtype
        np.testing.assert_allclose(_np(g), _np(w), **tol)
    assert fa_ops.flash_attention.launches == 0
    assert fa_ops.flash_attention_bwd.launches == 0


def test_flash_attention_bwd_wrapper_checks_shapes():
    q = torch.ones(1, 4, 2, 16)
    with pytest.raises(ValueError, match="must be q's"):
        fa_ops.flash_attention_bwd(q, q, q, q[:, :3], None, q)
    with pytest.raises(ValueError, match="not \\(B, S\\|Sk"):
        fa_ops.flash_attention_bwd(q, q[..., :8], q, q, None, q)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_without_query_rows_gives_zero_dk_dv(dtype):
    """S = 0 with Sk >= 1, which the wrapper accepts: dq is empty, and dk
    and dv are zeros of k's and v's shape (the card's path allocates them
    zeroed and launches nothing), not uninitialised memory."""
    rng = np.random.default_rng(7)
    q = torch.zeros(2, 0, 4, 16, dtype=dtype)
    k, v = (torch.from_numpy(_rand(rng, 2, 5, 2, 16)).to(dtype)
            for _ in range(2))
    dq, dk, dv = fa_ops.flash_attention_bwd(q, k, v, q, None, q)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert torch.equal(dk, torch.zeros_like(k))
    assert torch.equal(dv, torch.zeros_like(v))
    assert fa_ops.flash_attention_bwd.launches == 0
