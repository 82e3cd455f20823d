"""The port's analytical serving simulator (``perfmodel/simulator.py``)
against the JAX package's: every function over all 11 archs and every
hardware profile, bit for bit (the port copies the reference's
expressions in their order).

``decode_time_fn(setup, xp=torch)`` on float64 CPU tensors against the
numpy closure: bit for bit on the archs without MoE layers, whose closure
is only ``+ * / maximum where``, each correctly rounded.  On the MoE
archs the expert-hit term ``e * (1 - decay ** (bb * k))`` goes through
torch's ``pow``, whose ulp ``1 - decay ** x`` amplifies by up to ``1 /
(1 - decay) = e`` (128 at llama4-maverick): held within ``MOE_RTOL``
relative (CPU reading: at most 9.1e-16, llama4-maverick)."""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.perfmodel import hardware as jax_hw
from repro.perfmodel import simulator as jax_sim

from repro_torch.configs import ARCHS, get_config
from repro_torch.perfmodel import hardware
from repro_torch.perfmodel import simulator as sim

MOE_RTOL = 1e-13
CHIPS = (1, 4, 8)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensor ops: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setups(arch):
    """(port setup, reference setup) for every profile and TP degree."""
    for name in hardware.PROFILES:
        for chips in CHIPS:
            for eff in (1.0, 0.85):
                yield (sim.ServingSetup(get_config(arch),
                                        hardware.PROFILES[name], chips=chips,
                                        framework_eff=eff),
                       jax_sim.ServingSetup(jax_get_config(arch),
                                            jax_hw.PROFILES[name],
                                            chips=chips, framework_eff=eff))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _is_moe(arch):
    return any(b.ffn == "moe" for b in get_config(arch).period)


def _workload(seed, n=400):
    rng = np.random.default_rng(seed)
    bb = rng.integers(0, 600, n).astype(np.float64)
    bb[:8] = 0.0                                   # idle entries cost 0
    ctx = bb * rng.integers(1, 20000, n)
    return bb, ctx.astype(np.float64)


@pytest.mark.parametrize("arch", ARCHS)
def test_setup_terms_bit_equal(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert sim._per_layer_counts(cfg) == jax_sim._per_layer_counts(jcfg)
    for db in (1, 2, 4):
        _same(sim.kv_bytes_per_token(cfg, db),
              jax_sim.kv_bytes_per_token(jcfg, db))
        _same(sim.state_bytes(cfg, db), jax_sim.state_bytes(jcfg, db))
        for bb in (1, 3, 16, 64, 512, 1e9):
            _same(sim.weights_read_bytes(cfg, bb, db),
                  jax_sim.weights_read_bytes(jcfg, bb, db))
    for s, js in _setups(arch):
        _same(sim.weight_bytes_total(s), jax_sim.weight_bytes_total(js))
        _same(sim.kv_capacity_tokens(s), jax_sim.kv_capacity_tokens(js))


@pytest.mark.parametrize("arch", ARCHS)
def test_step_times_and_throughput_bit_equal(arch):
    rng = np.random.default_rng(7)
    for s, js in _setups(arch):
        ctx = rng.integers(1, 9000, 37)
        _same(sim.decode_step_time_group(s, ctx),
              jax_sim.decode_step_time_group(js, ctx))
        assert sim.decode_step_time_group(s, []) == 0.0
        prompts = rng.integers(1, 9000, 11)
        _same(sim.prefill_step_time(s, prompts),
              jax_sim.prefill_step_time(js, prompts))
        for ii, oo, bb in ((128, 64, 1), (2048, 512, 16), (512, 128, 7)):
            _same(sim.decode_step_time(s, bb, ii + oo / 2),
                  jax_sim.decode_step_time(js, bb, ii + oo / 2))
            _same(sim.prefill_time(s, ii, bb), jax_sim.prefill_time(js, ii, bb))
            _same(sim.throughput(s, ii, oo, bb),
                  jax_sim.throughput(js, ii, oo, bb))
        ii = rng.choice([128, 512, 2048], 50)
        oo = rng.choice([64, 256, 1024], 50)
        bb = rng.choice([1, 2, 8, 64], 50)
        _same(sim.throughput_batch(s, ii, oo, bb),
              jax_sim.throughput_batch(js, ii, oo, bb))


@pytest.mark.parametrize("arch", ARCHS)
def test_time_fn_closures_bit_equal(arch):
    bb, ctx = _workload(1)
    for s, js in _setups(arch):
        _same(sim.decode_time_fn(s)(bb, ctx), jax_sim.decode_time_fn(js)(bb, ctx))
        tok = bb * 300.0
        sq = bb * 300.0 ** 2
        pre, jpre = sim.prefill_time_fn(s), jax_sim.prefill_time_fn(js)
        _same(pre(tok, sq), jpre(tok, sq))
        for t in (0.0, 128.0, 4096.0):             # the scalar fast path
            _same(pre(t, t * t), jpre(t, t * t))


@pytest.mark.parametrize("arch", ARCHS)
def test_torch_decode_time_fn_against_numpy(arch):
    bb, ctx = _workload(2)
    for s, _ in _setups(arch):
        want = sim.decode_time_fn(s)(bb, ctx)
        got = sim.decode_time_fn(s, xp=torch)(torch.from_numpy(bb),
                                              torch.from_numpy(ctx))
        assert got.dtype == torch.float64
        got = got.numpy()
        assert np.all(got[bb == 0] == 0.0)
        if _is_moe(arch):
            np.testing.assert_allclose(got, want, rtol=MOE_RTOL, atol=0)
        else:
            _same(got, want)


def test_sample_throughput_bit_equal_draw_for_draw():
    for arch in ("llama3.1-8b", "phi3.5-moe-42b-a6.6b", "xlstm-125m"):
        for s, js in list(_setups(arch))[::5]:
            for sigma, p in ((0.05, 0.02), (0.08, 0.5)):
                got = sim.sample_throughput(s, 512, 128, 8, 9,
                                            np.random.default_rng(3),
                                            noise_sigma=sigma, straggler_p=p)
                want = jax_sim.sample_throughput(js, 512, 128, 8, 9,
                                                 np.random.default_rng(3),
                                                 noise_sigma=sigma,
                                                 straggler_p=p)
                _same(got, want)


def test_attention_free_capacity_is_unbounded():
    s = sim.ServingSetup(get_config("xlstm-125m"), hardware.TPU_V5E)
    assert sim.kv_capacity_tokens(s) == float("inf")
    assert sim.ServingSetup(get_config("llama3.1-8b"), hardware.TPU_V5E) \
        .chips == 4
