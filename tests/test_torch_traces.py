"""The port's workload traces (``serving/traces.py``) and fault plans
(``serving/faults.py``) against the JAX package's, draw for draw and bit
for bit: every arrival process, shape profiles and mixes, single-tenant
and multi-tenant traces with diurnal load and flash crowds, slices and
round trips; crash and straggler plans, their fingerprints, the
injector's slow factors and boundaries, and the telemetry corruption of
adapter rows."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.serving import faults as jf
from repro.serving import traces as jt

from repro_torch.serving import faults as tf
from repro_torch.serving import traces as tt


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.dtype == object:
        assert a.tolist() == b.tolist()
    else:
        assert a.tobytes() == b.tobytes()


def _same_trace(got, want):
    assert len(got) == len(want) and got.horizon_s == want.horizon_s
    g, w = got.to_arrays(), want.to_arrays()
    for k in w:
        _same(g[k], w[k])
    assert [r.rid for r in got.requests] == [r.rid for r in want.requests]
    assert got.tenants == want.tenants


def _fleet_cfg(m, horizon=300.0, seed=42):
    return m.FleetTraceConfig(tenants=(
        m.TenantConfig(name="chat", trace=m.TraceConfig(
            arrival="poisson", rate=30.0, shape_mix=m.mix(("chat", 1.0))),
            ttft_slo_s=1.5, diurnal_amp=0.4, diurnal_period_s=120.0),
        m.TenantConfig(name="summarize", trace=m.TraceConfig(
            arrival="gamma", rate=8.0, cv=2.0,
            shape_mix=m.mix(("summarize", 1.0))), ttft_slo_s=8.0),
        m.TenantConfig(name="generate", trace=m.TraceConfig(
            arrival="mmpp", rate=12.0, burst_rate=24.0,
            shape_mix=m.mix(("generate", 1.0))), ttft_slo_s=4.0,
            flash_crowds=2, flash_mult=3.0, flash_dur_s=15.0),
    ), horizon_s=horizon, seed=seed)


@pytest.mark.parametrize("seed", [0, 7])
def test_arrival_processes_draw_for_draw(seed):
    for fn, kw in ((tt.poisson_arrivals, {}), (tt.gamma_arrivals, {}),
                   (tt.gamma_arrivals, dict(cv=0.5))):
        got = fn(6.0, 50.0, np.random.default_rng(seed), **kw)
        want = getattr(jt, fn.__name__)(6.0, 50.0,
                                        np.random.default_rng(seed), **kw)
        _same(got, want)
    got = tt.mmpp_arrivals(2.0, 20.0, 90.0, np.random.default_rng(seed),
                           dwell_lo_s=5.0, dwell_hi_s=2.0)
    want = jt.mmpp_arrivals(2.0, 20.0, 90.0, np.random.default_rng(seed),
                            dwell_lo_s=5.0, dwell_hi_s=2.0)
    _same(got, want)
    _same(tt.mmpp_arrivals(0.0, 0.0, 10.0, np.random.default_rng(seed)),
          jt.mmpp_arrivals(0.0, 0.0, 10.0, np.random.default_rng(seed)))
    assert sorted(tt.ARRIVALS) == sorted(jt.ARRIVALS)


def test_shape_profiles_and_mixes_draw_for_draw():
    for name in jt.PROFILES:
        assert dataclasses.astuple(tt.PROFILES[name]) == \
            dataclasses.astuple(jt.PROFILES[name])
        for a, b in zip(tt.PROFILES[name].sample(200, np.random.default_rng(1)),
                        jt.PROFILES[name].sample(200, np.random.default_rng(1))):
            _same(a, b)
    spec = (("chat", 0.5), ("summarize", 0.2), ("generate", 0.3))
    for a, b in zip(tt.mix(*spec).sample(500, np.random.default_rng(2)),
                    jt.mix(*spec).sample(500, np.random.default_rng(2))):
        _same(a, b)


@pytest.mark.parametrize("arrival", ["poisson", "gamma", "mmpp"])
def test_make_trace_bit_equal(arrival):
    kw = dict(arrival=arrival, rate=5.0, horizon_s=80.0, seed=11, cv=1.5,
              burst_rate=18.0 if arrival == "mmpp" else None)
    got = tt.make_trace(tt.TraceConfig(
        shape_mix=tt.mix(("chat", 0.7), ("generate", 0.3)), **kw))
    want = jt.make_trace(jt.TraceConfig(
        shape_mix=jt.mix(("chat", 0.7), ("generate", 0.3)), **kw))
    _same_trace(got, want)
    _same_trace(got.slice(20.0, 40.0), want.slice(20.0, 40.0))
    a = got.to_arrays()
    back = tt.Trace.from_arrays(a["arrival_s"][::-1], a["ii"][::-1],
                                a["oo"][::-1], horizon_s=80.0)
    _same_trace(back, got)
    with pytest.raises(KeyError, match="unknown arrival"):
        tt.make_trace(tt.TraceConfig(arrival="weibull"))


@pytest.mark.parametrize("seed", [42, 5])
def test_fleet_trace_diurnal_and_flash_crowds_bit_equal(seed):
    got = tt.make_fleet_trace(_fleet_cfg(tt, seed=seed))
    want = jt.make_fleet_trace(_fleet_cfg(jt, seed=seed))
    _same_trace(got, want)
    assert got.tenants and set(got.tenants) == {"chat", "summarize",
                                                "generate"}
    assert got.fleet_config.slo_map == want.fleet_config.slo_map
    tc, jtc = got.fleet_config.tenants[2], want.fleet_config.tenants[2]
    t = np.linspace(0.0, 300.0, 601)
    crowds = np.array([40.0, 200.0])
    _same(tc.envelope(t, crowds), jtc.envelope(t, crowds))
    assert tc.envelope_max == jtc.envelope_max
    _same_trace(got.slice(100.0, 160.0), want.slice(100.0, 160.0))
    with pytest.raises(ValueError, match="duplicate"):
        tt.make_fleet_trace(tt.FleetTraceConfig(
            tenants=(tc, tc), horizon_s=10.0))
    with pytest.raises(ValueError, match="at least one"):
        tt.make_fleet_trace(tt.FleetTraceConfig(tenants=()))


FAULTS = [dict(seed=3, horizon_s=120.0, mttf_s=30.0, mttr_s=4.0,
               straggler_rate_hz=0.05, straggler_dur_s=6.0),
          dict(seed=9, horizon_s=60.0, n_replicas=3, mttf_s=10.0),
          dict(seed=1, horizon_s=60.0, straggler_rate_hz=0.2,
               straggler_slow=5.0),
          dict()]


@pytest.mark.parametrize("kw", FAULTS, ids=["both", "crashes", "stragglers",
                                            "none"])
def test_fault_plans_and_injector_bit_equal(kw):
    plan, jplan = tf.FaultPlan.build(tf.FaultConfig(**kw)), \
        jf.FaultPlan.build(jf.FaultConfig(**kw))
    assert [dataclasses.astuple(c) for c in plan.crashes] == \
        [dataclasses.astuple(c) for c in jplan.crashes]
    assert [dataclasses.astuple(s) for s in plan.stragglers] == \
        [dataclasses.astuple(s) for s in jplan.stragglers]
    assert plan.fingerprint() == jplan.fingerprint()
    inj, jinj = tf.FaultInjector(plan), jf.FaultInjector(jplan)
    assert inj.crash_windows() == plan.crashes
    for rid in range(plan.cfg.n_replicas):
        _same(inj.straggler_boundaries(rid), jinj.straggler_boundaries(rid))
        for t in np.linspace(0.0, plan.cfg.horizon_s, 97):
            assert inj.slow_factor(rid, t) == jinj.slow_factor(rid, t)


def test_telemetry_corruption_bit_equal():
    kw = dict(seed=4, drop_p=0.1, dup_p=0.1, poison_nan_p=0.1,
              poison_scale_p=0.15, poison_scale=40.0)
    rows = [dict(model="m", ii=128 * (i % 4 + 1), oo=64, bb=1 + i % 8,
                 thpt=1000.0 + 3.0 * i) for i in range(120)]
    inj, jinj = tf.injector(tf.FaultConfig(**kw)), \
        jf.injector(jf.FaultConfig(**kw))
    for _ in range(2):                 # the stream carries on across calls
        out, rep = inj.corrupt_rows(rows)
        jout, jrep = jinj.corrupt_rows(rows)
        assert len(out) == len(jout)
        for a, b in zip(out, jout):
            assert a.keys() == b.keys()
            assert all(np.float64(a[k]).tobytes() == np.float64(b[k]).tobytes()
                       if isinstance(b[k], float) else a[k] == b[k]
                       for k in b)
        assert (rep.n_in, rep.n_dropped, rep.n_duplicated, rep.n_poisoned) \
            == (jrep.n_in, jrep.n_dropped, jrep.n_duplicated, jrep.n_poisoned)
        assert rep.clean_rows == jrep.clean_rows
    assert rep.n_dropped and rep.n_duplicated and rep.n_poisoned
