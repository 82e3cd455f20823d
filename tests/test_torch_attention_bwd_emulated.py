"""K2's bf16 backward arithmetic, emulated step for step in plain torch
(``kernels/flash_attention/emulate.py::attention_bwd_bf16_emulated``), on
the CPU against the reference: ``jax.vjp`` of ``repro.models.attention.
_sdpa`` computed in bf16, and the plain backward formulas of
``ref.attention_bwd_ref`` in fp32 on the same bf16 values.  The card's
kernel is held to this emulation at one bf16 ulp
(``tests/test_torch_gpu.py``), so the two comparisons tie the kernel's
rounding points to the reference.

Tolerances: against JAX's bf16 gradient 2e-2 (absolute and relative, the
port's bf16 tolerance): JAX rounds the scores, the probabilities and every
product's output to bf16 where the kernel keeps fp32; against the fp32
formulas 1e-2 of each gradient's largest magnitude, plus 1e-5: the
emulation rounds only P and dS to bf16 (2^-9 relative each) before sums
of up to 160 terms, and its outputs once; a lone causal row's dK and dQ
cancel to about 1e-7 (dP - D of a row that sees one key).  Inputs are
drawn with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as jattn

from repro_torch.kernels.flash_attention.emulate import (
    attention_bf16_emulated, attention_bwd_bf16_emulated)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)

# (B, Sq, Sk, H, KV, Dh, causal): a ragged causal tile at G 2, Sk > Sq at
# G 4 without a mask, Sk < Sq under the top-left mask at G 4, Sq 1, and
# G 7 (internvl2's 14/2 heads) at Dh 16
CASES = [(1, 70, 70, 4, 2, 64, True), (2, 33, 80, 4, 1, 32, False),
         (1, 90, 40, 8, 2, 16, True), (2, 1, 50, 2, 1, 32, True),
         (1, 40, 40, 14, 2, 16, True)]
JAX_TOL = dict(rtol=2e-2, atol=2e-2)
FP32_TOL, FP32_FLOOR = 1e-2, 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(seed, b, sq, sk, h, kv, dh, causal):
    """bf16 q, k, v, dout (B, S|Sk, H|KV, Dh) from numpy, the kernel's
    forward output (emulated) and the rows' fp32 log-sum-exp."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to(torch.bfloat16) for shape in
        ((b, sq, h, dh), (b, sk, kv, dh), (b, sk, kv, dh), (b, sq, h, dh)))
    out = attention_bf16_emulated(q, k, v, causal=causal)
    _, lse = attention_ref(*(t.transpose(1, 2) for t in (q, k, v)),
                           causal=causal, return_lse=True)
    return q, k, v, out, lse, do


def _jax_bf16_grads(q, k, v, do, causal, scale):
    """jax.vjp of the reference's ``_sdpa`` in bf16 (grouped heads, the
    top-left causal mask), as fp32 numpy arrays."""
    b, sq, h, dh = q.shape
    sk, kv = k.shape[1], k.shape[2]
    mask = None
    if causal:
        mask = (jnp.arange(sq)[:, None] >= jnp.arange(sk)[None, :])[
            None, None, None]

    def fn(q, k, v):
        return jattn._sdpa(q.reshape(b, sq, kv, h // kv, dh), k, v, mask,
                           scale).reshape(b, sq, h, dh)

    def j(t):
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)

    grads = jax.jit(lambda p, c: jax.vjp(fn, *p)[1](c))(
        (j(q), j(k), j(v)), j(do))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_emulation_matches_jax_vjp_of_sdpa_in_bf16(case):
    b, sq, sk, h, kv, dh, causal = case
    q, k, v, out, lse, do = _inputs(30, *case)
    scale = dh ** -0.5
    got = attention_bwd_bf16_emulated(q, k, v, out, lse, do, causal=causal,
                                      scale=scale)
    want = _jax_bf16_grads(q, k, v, do, causal, scale)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape
        np.testing.assert_allclose(g.float().numpy(), w, **JAX_TOL)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_bwd_emulation_matches_the_plain_formulas_in_fp32(case):
    b, sq, sk, h, kv, dh, causal = case
    q, k, v, out, lse, do = _inputs(31, *case)
    got = attention_bwd_bf16_emulated(q, k, v, out, lse, do, causal=causal)
    want = attention_bwd_ref(*(t.transpose(1, 2).float()
                               for t in (q, k, v, out, do)), causal=causal)
    for g, w in zip(got, want):
        w = w.transpose(1, 2)
        err = (g.float() - w).abs().max()
        assert err <= FP32_TOL * w.abs().max() + FP32_FLOOR, \
            (err, w.abs().max())

