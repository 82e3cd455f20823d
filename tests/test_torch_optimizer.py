"""AdamW, its schedule and global norm, the int8 gradient compression
and the straggler monitor against the reference package's, given the
same inputs.

AdamW: new params, m and v within 1e-6 relative over 5 steps (the same
fp32 expressions; only the summation order of the global norm and the
powers' rounding differ).  Compression: the int8 values, scales and
error-feedback residuals bit for bit (IEEE fp32 division and
round-half-to-even on both sides).  The straggler monitor is a copy, held
to the reference's decisions on the same traces, with ports of the
reference's tests."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import compression as jcomp
from repro.training import optimizer as jopt
from repro.training.straggler import StragglerConfig as JStragglerConfig
from repro.training.straggler import StragglerMonitor as JStragglerMonitor

from repro_torch.training import compression as comp
from repro_torch.training import optimizer as opt
from repro_torch.training.straggler import StragglerConfig, StragglerMonitor


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


SHAPES = {"embed.tok_embed": (17, 8), "blocks.0.0.attn.wq": (8, 2, 4),
          "final_norm.scale": (8,)}


def _tree(rng, scale=1.0, positive=False):
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32)
           for k, s in SHAPES.items()}
    return {k: np.abs(v) if positive else v for k, v in out.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("cfg", [
    opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10),
    opt.AdamWConfig(weight_decay=0.0, grad_clip=1e9, warmup_steps=0),
    opt.AdamWConfig(lr=3e-3, grad_clip=0.05, warmup_steps=5,
                    total_steps=30)], ids=["trainer", "no-clip", "clipped"])
def test_adamw_update_matches_reference(cfg):
    jcfg = jopt.AdamWConfig(**{f: getattr(cfg, f)
                               for f in cfg.__dataclass_fields__})
    rng = np.random.default_rng(0)
    params = _tree(rng)
    jp, tp = _jax(params), _torch(params)
    jstate, tstate = jopt.adamw_init(jp), opt.adamw_init(tp)
    for step in range(5):
        grads = _tree(rng, scale=0.1 * (step + 1))
        jp, jstate, jm = jopt.adamw_update(jcfg, jp, _jax(grads), jstate)
        tp, tstate, tm = opt.adamw_update(cfg, tp, _torch(grads), tstate)
        assert int(tstate.step) == int(jstate.step) == step + 1
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        for k in SHAPES:
            for got, want in ((tp[k], jp[k]), (tstate.m[k], jstate.m[k]),
                              (tstate.v[k], jstate.v[k])):
                assert got.dtype == torch.float32
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6, atol=1e-9)


def test_adamw_keeps_a_parameters_dtype():
    p = {"w": torch.ones(4, dtype=torch.bfloat16)}
    state = opt.adamw_init(p)
    assert state.m["w"].dtype == torch.float32
    out, state, _ = opt.adamw_update(opt.AdamWConfig(warmup_steps=0), p,
                                     {"w": torch.ones(4)}, state)
    assert out["w"].dtype == torch.bfloat16 and out["w"] is p["w"]


def test_lr_schedule_matches_reference():
    for cfg in (opt.AdamWConfig(), opt.AdamWConfig(warmup_steps=0,
                                                   total_steps=1),
                opt.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=12)):
        jcfg = jopt.AdamWConfig(**{f: getattr(cfg, f)
                                   for f in cfg.__dataclass_fields__})
        steps = np.array([0, 1, 2, 5, 50, 100, 101, 5000, 10_000, 20_000],
                         np.int32)
        want = np.asarray(jopt.lr_schedule(jcfg, jnp.asarray(steps)))
        got = opt.lr_schedule(cfg, torch.from_numpy(steps)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12)


def test_global_norm_matches_reference():
    rng = np.random.default_rng(1)
    tree = _tree(rng, scale=3.0)
    tree["x"] = rng.standard_normal(1000).astype(np.float32)
    want = float(jopt.global_norm(_jax(tree)))
    got = opt.global_norm(_torch(tree))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    bf = {"a": torch.ones(3, dtype=torch.bfloat16)}
    assert float(opt.global_norm(bf)) == pytest.approx(3 ** 0.5)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_quantize_int8_is_the_references_bit_for_bit(seed, scale):
    x = (np.random.default_rng(seed).standard_normal(257) * scale).astype(
        np.float32)
    x[:3] = [0.0, x.max() * 0.5, -x.max() * 0.5]   # ties of round()
    jq, js = jcomp.quantize_int8(jnp.asarray(x))
    tq, ts = comp.quantize_int8(torch.from_numpy(x))
    assert tq.dtype == torch.int8
    assert tq.numpy().tobytes() == np.asarray(jq).tobytes()
    assert ts.numpy().tobytes() == np.asarray(js).tobytes()
    np.testing.assert_array_equal(
        comp.dequantize_int8(tq, ts).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js)))
    # at most half a step, give or take the fp32 rounding of q * scale - x
    # (the constructed ties sit at exactly half a step)
    err = np.abs(comp.dequantize_int8(tq, ts).numpy() - x)
    assert err.max() <= float(ts) * 0.5 + 2 * np.spacing(np.abs(x).max())


def test_error_feedback_is_the_references_bit_for_bit():
    """With EF, the *cumulative* compressed gradient tracks the true sum;
    every step's codes and residuals are the reference's."""
    rng = np.random.default_rng(0)
    grads = [{"w": (rng.standard_normal(64) * 0.01 + 0.003).astype(
        np.float32), "b": rng.standard_normal(5).astype(np.float32)}
        for _ in range(50)]
    jef = jcomp.init_ef_state(_jax(grads[0]))
    tef = comp.init_ef_state(_torch(grads[0]))
    acc_comp, acc_true = np.zeros(64), np.zeros(64)
    for g in grads:
        jq, jef = jcomp.compress_with_feedback(_jax(g), jef)
        tq, tef = comp.compress_with_feedback(_torch(g), tef)
        for k in g:
            assert tq[k][0].numpy().tobytes() == np.asarray(jq[k][0]).tobytes()
            assert tef.residual[k].numpy().tobytes() == \
                np.asarray(jef.residual[k]).tobytes()
        acc_comp += comp.decompress(tq)["w"].numpy()
        acc_true += g["w"]
    # residual is bounded by one quantization step, not O(n_steps)
    resid = np.abs(acc_comp - acc_true).max()
    single_step = np.abs(grads[0]["w"]).max() / 127
    assert resid <= 2 * single_step + 1e-6


def test_straggler_detection():
    mon = StragglerMonitor(StragglerConfig(window=16, threshold=1.5))
    for step in range(10):
        for host in range(8):
            mon.record(host, 1.0 if host != 3 else 2.5)
    assert mon.stragglers() == [3]


def test_bounded_staleness():
    mon = StragglerMonitor(StragglerConfig(max_stale=2))
    assert mon.should_proceed_without(7)
    assert mon.should_proceed_without(7)
    assert not mon.should_proceed_without(7)   # staleness bound hit
    mon.mark_arrived(7)
    assert mon.should_proceed_without(7)


def test_straggler_monitor_decides_as_the_reference():
    rng = np.random.default_rng(2)
    mons = (StragglerMonitor(StragglerConfig(window=8, threshold=1.3)),
            JStragglerMonitor(JStragglerConfig(window=8, threshold=1.3)))
    for step in range(40):
        host = int(rng.integers(0, 6))
        dur = float(rng.gamma(2.0, 0.5) * (2.0 if host == 4 else 1.0))
        for m in mons:
            m.record(host, dur)
        assert mons[0].stragglers() == mons[1].stragglers()
        assert mons[0].median_duration() == mons[1].median_duration()
        if step % 5 == 0:
            assert mons[0].should_proceed_without(host) == \
                mons[1].should_proceed_without(host)
