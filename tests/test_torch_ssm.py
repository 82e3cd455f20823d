"""The port's recurrent mixers (Mamba, mLSTM, sLSTM) against the JAX
package's: each mixer's full (prefill) and decode functions, outputs and
states, in fp32 (1e-4: the same math, another summation order) and bf16
(2e-2); the state carried across chunks, from one call into the next and
into decode; decode after a prefill equal to a teacher-forced prefill;
and sLSTM's recurrent product held to float32, as the reference's type
promotion makes it.  Weights come from the JAX smoke models through
``params_from_jax``; inputs are drawn with numpy from seeds."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.models import ssm as jssm
from repro.models.transformer import Model as JaxModel

from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import Model
from repro_torch.weights import params_from_jax

# mixer: (arch, period position, prefill length over several chunks)
MIXERS = {"mamba": ("jamba-1.5-large-398b", 0, 48),
          "mlstm": ("xlstm-125m", 1, 128),
          "slstm": ("xlstm-125m", 0, 24)}
_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B = 2


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


class _Pair:
    """One mixer of a smoke model in both packages, the same weights."""

    def __init__(self, mixer, dtype_name, seed=0):
        arch, pos, self.s = MIXERS[mixer]
        jdt, tdt, self.tol = _DTYPES[dtype_name]
        self.mixer = mixer
        self.jcfg = jax_get_smoke_config(arch).scaled(compute_dtype=jdt)
        self.tcfg = get_smoke_config(arch).scaled(compute_dtype=tdt)
        params = JaxModel(self.jcfg).init(jax.random.key(seed))
        model = Model(self.tcfg).load(params_from_jax(
            jax.tree.map(np.asarray, params), self.tcfg, "cpu"))
        block = jax.tree.map(lambda t: t[0], params["blocks"][pos])
        # the reference's Mamba functions take the block, the others the
        # mixer's own tree; the port's all take the mixer's
        self.jp = block if mixer == "mamba" else block[mixer]
        self.tp = model.blocks[0][pos][mixer]

    def x(self, seed, s):
        x = np.random.default_rng(seed).standard_normal(
            (B, s, self.tcfg.d_model)).astype(np.float32)
        return (jnp.asarray(x, self.jcfg.compute_dtype),
                torch.from_numpy(x).to(self.tcfg.compute_dtype))

    def full(self, jx, tx, jstate=None, tstate=None):
        jfn = getattr(jssm, f"{self.mixer}_full")
        tfn = getattr(tssm, f"{self.mixer}_full")
        return (jfn(self.jcfg, self.jp, jx, jstate),
                tfn(self.tcfg, self.tp, tx, tstate))

    def decode(self, jx, tx, jstate, tstate):
        jfn = getattr(jssm, f"{self.mixer}_decode")
        tfn = getattr(tssm, f"{self.mixer}_decode")
        return (jfn(self.jcfg, self.jp, jx, jstate),
                tfn(self.tcfg, self.tp, tx, tstate))

    def close(self, j, t, tol=None):
        """(out, state) of both packages agree: every tensor, state
        fields by name and shape."""
        tol = self.tol if tol is None else tol
        (jy, js), (ty, ts) = j, t
        assert ty.shape == jy.shape and ty.dtype == self.tcfg.compute_dtype
        np.testing.assert_allclose(_np(ty), _np(jy), rtol=tol, atol=tol)
        assert ts._fields == js._fields
        for name, a, b in zip(js._fields, js, ts):
            assert tuple(b.shape) == a.shape, name
            np.testing.assert_allclose(_np(b), _np(a), rtol=tol, atol=tol,
                                       err_msg=name)


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_full_matches_jax(mixer, dtype_name):
    pair = _Pair(mixer, dtype_name)
    jx, tx = pair.x(1, pair.s)
    pair.close(*pair.full(jx, tx))


@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", list(MIXERS))
def test_mixer_decode_matches_jax(mixer, dtype_name):
    """Four decode steps from the state a prefill left, in both packages
    (each from its own prefill's state)."""
    pair = _Pair(mixer, dtype_name)
    jx, tx = pair.x(2, pair.s)
    (_, js), (_, ts) = pair.full(jx, tx)
    for n in range(4):
        jt, tt = pair.x(10 + n, 1)
        j, t = pair.decode(jt, tt, js, ts)
        pair.close(j, t)
        js, ts = j[1], t[1]


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_state_carries_across_chunks_and_calls(mixer):
    """A prefill cut in two, the second call starting from the first's
    state, gives the whole prefill's output and state; the reference does
    the same from the same state."""
    pair = _Pair(mixer, "float32")
    jx, tx = pair.x(3, 2 * pair.s)
    (jy, js), _ = pair.full(jx, tx)
    (_, js1), (ty1, ts1) = pair.full(jx[:, :pair.s], tx[:, :pair.s])
    (jy2, js2), (ty2, ts2) = pair.full(jx[:, pair.s:], tx[:, pair.s:],
                                       js1, ts1)
    pair.close((jy2, js2), (ty2, ts2))
    pair.close((jy, js), (torch.cat([ty1, ty2], 1), ts2))


@pytest.mark.parametrize("mixer", list(MIXERS))
def test_decode_after_prefill_is_the_teacher_forced_prefill(mixer):
    """Prefill 16 positions and decode 16 more one at a time: each step's
    output is the prefill over all 32 at that position, and the last
    state is its state."""
    pair = _Pair(mixer, "float32")
    _, tx = pair.x(4, 32)
    cfg, fn = pair.tcfg, getattr(tssm, f"{mixer}_decode")
    want, want_state = getattr(tssm, f"{mixer}_full")(cfg, pair.tp, tx)
    _, state = getattr(tssm, f"{mixer}_full")(cfg, pair.tp, tx[:, :16])
    for t in range(16, 32):
        y, state = fn(cfg, pair.tp, tx[:, t:t + 1], state)
        np.testing.assert_allclose(_np(y), _np(want[:, t:t + 1]),
                                   rtol=1e-4, atol=1e-4, err_msg=str(t))
    for name, a, b in zip(state._fields, state, want_state):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-4, atol=1e-4,
                                   err_msg=name)


def test_slstm_recurrent_product_is_float32():
    """bf16 compute: the reference multiplies the float32 h by r_proj in
    the compute type, and jnp.einsum promotes the pair to float32.  The
    port's step is held to the reference's step within 1e-6 over 16
    positions; the same step with the product in bf16 misses it by far
    more, so this test fails if the product is rounded to bf16."""
    pair = _Pair("slstm", "bfloat16")
    r = pair.tp["r_proj"]
    dp = r.shape[0]
    wx = np.random.default_rng(5).standard_normal((16, B, 4 * dp))
    wx = wx.astype(np.float32)

    def run(step):
        state = tssm.init_slstm_state(pair.tcfg, B, "cpu")
        for t in range(16):
            state = step(state, torch.from_numpy(wx[t]))
        return np.stack([_np(s) for s in state])

    jcarry = tuple(jnp.zeros((B, dp), jnp.float32) for _ in range(3))
    for t in range(16):
        jcarry, _ = jssm._slstm_step(pair.jp, jnp.bfloat16, jcarry,
                                     jnp.asarray(wx[t]))
    want = np.stack([_np(s) for s in jcarry])
    got = run(lambda st, w: tssm._slstm_step(r.float(), st, w))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def bf16_product(st, w):  # h rounded to bf16 and a bf16 matmul
        class _R:
            def __rmatmul__(self, h):
                return (h.to(torch.bfloat16) @ r).float()
        return tssm._slstm_step(_R(), st, w)

    assert np.abs(run(bf16_product) - want).max() > 1e-3


@pytest.mark.parametrize("mixer,s", [("mamba", 40), ("mlstm", 96)])
def test_chunked_mixers_refuse_a_ragged_prefill(mixer, s):
    pair = _Pair(mixer, "float32")
    _, tx = pair.x(6, s)
    with pytest.raises(ValueError, match="multiple of its chunk"):
        getattr(tssm, f"{mixer}_full")(pair.tcfg, pair.tp, tx)
