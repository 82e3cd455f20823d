"""The port's serving engines (``serving/simulator.py``, the event heap,
and ``serving/fleet.py``, the time-bucketed vectorized engine) and the
adapter (``serving/adapter.py``) against the JAX package's, on small
seeded traces: with and without crash and straggler faults, under a
``StaticPolicy`` that scales the fleet, with a KV cap that sheds, and on
a fleet of mixed hardware.  Every result is held bit for bit: the
per-request ``req`` arrays (fleet engine) or records (heap engine), the
step stream, ``accounting()``, ``n_events``, ``sim_end_s``, replica
seconds, availability, controls, the fault log, percentiles, the
per-tenant rollup and the meta-metrics; the reference's own
``tests/_sim_invariants.py`` checks run on every port result.

The ``"torch"`` trajectory backend on the CPU against ``"numpy"``: bit
for bit on a dense config; on llama4-maverick (MoE), whose step times
the device's ``pow`` may move by a few ulps (``test_torch_simulator.py``),
the same accounting and events and every time within ``MOE_ATOL_S``."""
import math

import numpy as np
import pytest
import torch

from _sim_invariants import assert_per_tenant_consistent, \
    assert_sim_invariants
from repro.configs import get_config as jax_get_config
from repro.obs import ObsConfig as JaxObsConfig
from repro.perfmodel import hardware as jax_hw
from repro.perfmodel.simulator import ServingSetup as JaxSetup
from repro.serving import adapter as jad
from repro.serving import faults as jf
from repro.serving import simulator as jsim
from repro.serving import traces as jt
from repro.serving.autoscaler import StaticPolicy as JaxStatic

from repro_torch.configs import get_config
from repro_torch.obs import ObsConfig
from repro_torch.perfmodel import hardware
from repro_torch.perfmodel.simulator import ServingSetup
from repro_torch.serving import adapter as tad
from repro_torch.serving import faults as tf
from repro_torch.serving import simulator as tsim
from repro_torch.serving import traces as tt
from repro_torch.serving.autoscaler import StaticPolicy
from repro_torch.serving.fleet import VectorFleetSimulator

MOE_ATOL_S = 1e-9
REQ_COLS = ("rid", "ii", "oo", "arrival_s", "tenant", "replica",
            "first_token_s", "done_s", "retries", "shed", "shed_s",
            "shed_reason")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _setups(arch="llama3.1-8b", hw="tpu-v5e", chips=4):
    return (ServingSetup(get_config(arch), hardware.PROFILES[hw],
                         chips=chips),
            JaxSetup(jax_get_config(arch), jax_hw.PROFILES[hw], chips=chips))


def _fleet_cfg(m, horizon=40.0):
    return m.FleetTraceConfig(tenants=(
        m.TenantConfig(name="chat", trace=m.TraceConfig(
            arrival="poisson", rate=6.0, shape_mix=m.mix(("chat", 1.0))),
            ttft_slo_s=1.5, diurnal_amp=0.4, diurnal_period_s=30.0),
        m.TenantConfig(name="summarize", trace=m.TraceConfig(
            arrival="gamma", rate=2.0, cv=2.0,
            shape_mix=m.mix(("summarize", 1.0))), ttft_slo_s=8.0),
        m.TenantConfig(name="generate", trace=m.TraceConfig(
            arrival="mmpp", rate=3.0, burst_rate=8.0,
            shape_mix=m.mix(("generate", 1.0))), ttft_slo_s=4.0,
            flash_crowds=2, flash_mult=3.0, flash_dur_s=5.0),
    ), horizon_s=horizon, seed=42)


@pytest.fixture(scope="module")
def traces():
    return (tt.make_fleet_trace(_fleet_cfg(tt)),
            jt.make_fleet_trace(_fleet_cfg(jt)))


FAULTS = dict(seed=3, horizon_s=40.0, n_replicas=4, mttf_s=12.0,
              mttr_s=3.0, straggler_rate_hz=0.1, straggler_dur_s=4.0)
SCENARIOS = {
    "plain": dict(n_replicas=2),
    "faults": dict(n_replicas=3, faults=FAULTS, max_retries=1,
                   shed_after_s=15.0),
    "static-policy": dict(n_replicas=1, max_replicas=4, policy=(3, 16),
                          control_interval_s=4.0),
    "kv-capped": dict(n_replicas=2, kv_capacity_override=3000.0,
                      batch_cap=8),
    "mixed-hardware": dict(n_replicas=3, hetero=True, faults=FAULTS),
}


def _configs(scn, setups, **extra):
    """(port SimConfig, reference SimConfig, port policy, reference
    policy) for a scenario."""
    kw = dict(scn)
    policy = kw.pop("policy", None)
    fault_kw = kw.pop("faults", None)
    hetero = kw.pop("hetero", False)
    out = []
    for m, faults, setup, other, pol in (
            (tsim, tf, setups[0], _setups(hw="gpu-h100-sxm", chips=1)[0],
             StaticPolicy),
            (jsim, jf, setups[1], _setups(hw="gpu-h100-sxm", chips=1)[1],
             JaxStatic)):
        c = dict(kw, **extra)
        if fault_kw is not None:
            c["faults"] = faults.injector(faults.FaultConfig(**fault_kw))
        if hetero:
            c["replica_setups"] = (setup, other)
        if m is jsim:
            c.pop("device", None)
            if c.get("traj_backend") == "torch":
                c["traj_backend"] = "numpy"
        p = None if policy is None else pol(n_replicas=policy[0],
                                            batch_cap=policy[1])
        out.append((m.SimConfig(setup=setup, bucket_s=0.25, **c), p))
    (cfg, pol), (jcfg, jpol) = out
    return cfg, jcfg, pol, jpol


def _same_float(a, b):
    assert (isinstance(a, float) and math.isnan(a) and math.isnan(b)) or \
        np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)


def _same_obj(a, b):
    if isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _same_obj(a[k], b[k])
    elif isinstance(b, float):
        _same_float(a, b)
    else:
        assert a == b


def _records(res):
    return [tuple(getattr(r, k) for k in REQ_COLS) for r in res.records]


def _steps(res):
    return [(s.t_end, s.replica, s.kind, s.bb, s.duration_s, s.tokens_out)
            for s in res.steps]


def _same_result(got, want, slo_map):
    assert got.accounting() == want.accounting()
    assert (got.n_events, got.sim_end_s, got.t_start) == \
        (want.n_events, want.sim_end_s, want.t_start)
    _same_float(got.replica_seconds, want.replica_seconds)
    _same_float(got.availability, want.availability)
    assert [(t, a.n_replicas, a.batch_cap, a.hardware)
            for t, a in got.controls] == \
        [(t, a.n_replicas, a.batch_cap, a.hardware) for t, a in want.controls]
    assert [(e.t, e.kind, e.replica, e.n_displaced) for e in got.fault_log] \
        == [(e.t, e.kind, e.replica, e.n_displaced) for e in want.fault_log]
    assert got.replica_hw == want.replica_hw
    _same_obj(got.step_totals, want.step_totals)
    if hasattr(want, "req"):
        for k in want.req:
            a, b = got.req[k], want.req[k]
            assert a.dtype == b.dtype, k
            assert (a.tolist() == b.tolist() if b.dtype == object
                    else a.tobytes() == b.tobytes()), k
        for k in want.step_arrays:
            assert got.step_arrays[k].tobytes() == \
                want.step_arrays[k].tobytes(), k
    assert _records(got) == _records(want)
    assert _steps(got) == _steps(want)
    assert got.n_retries == want.n_retries
    for slo in (0.5, 2.0, 1e12):
        _same_float(got.slo_attainment(slo), want.slo_attainment(slo))
    for q in (10.0, 50.0, 95.0, 99.0):
        _same_float(got.ttft_percentile(q), want.ttft_percentile(q))
        _same_float(got.ttft_percentile(q, on_missing="drop"),
                    want.ttft_percentile(q, on_missing="drop"))
    _same_float(got.goodput_tok_s, want.goodput_tok_s)
    _same_obj(got.per_tenant(slo_map), want.per_tenant(slo_map))
    _same_obj(got.meta_metrics(slo_map), want.meta_metrics(slo_map))


@pytest.mark.parametrize("engine", ["heap", "fleet"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_engine_bit_equal_to_the_reference(engine, name, traces):
    tr, jtr = traces
    cfg, jcfg, pol, jpol = _configs(SCENARIOS[name], _setups())
    got = tsim.simulate(tr, cfg, pol, engine=engine)
    want = jsim.simulate(jtr, jcfg, jpol, engine=engine)
    slo = tr.fleet_config.slo_map
    _same_result(got, want, slo)
    assert_sim_invariants(got, tr)
    assert_per_tenant_consistent(got, slo)
    if name == "faults":
        assert got.fault_log and got.n_retries
    if name == "static-policy":
        assert {a.n_replicas for _, a in got.controls} == {3}
    if name == "kv-capped":
        assert got.accounting()["shed"] > 0
    if name == "mixed-hardware":
        assert len(got.hardware_names) == 2


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_epoch_slice_with_t_start_bit_equal(engine, traces):
    tr, jtr = traces
    cfg, jcfg, _, _ = _configs(dict(n_replicas=2, t_start=10.0), _setups())
    got = tsim.simulate(tr.slice(10.0, 25.0), cfg, engine=engine)
    want = jsim.simulate(jtr.slice(10.0, 25.0), jcfg, engine=engine)
    _same_result(got, want, tr.fleet_config.slo_map)


@pytest.mark.parametrize("name", ["plain", "faults", "static-policy"])
def test_torch_backend_on_cpu_bit_equal_on_dense(name, traces):
    tr, _ = traces
    cfg, _, pol, _ = _configs(SCENARIOS[name], _setups())
    tcfg, _, tpol, _ = _configs(SCENARIOS[name], _setups(),
                                traj_backend="torch", device="cpu")
    want = VectorFleetSimulator(tr, cfg, pol)
    got = VectorFleetSimulator(tr, tcfg, tpol)
    want_res, got_res = want.run(), got.run()
    _same_result(got_res, want_res, tr.fleet_config.slo_map)
    assert got.traj_calls == want.traj_calls > 0
    assert got.traj_steps == want.traj_steps >= got.traj_calls


def test_torch_backend_on_cpu_moe_within_tolerance(traces):
    tr, _ = traces
    setups = _setups("llama4-maverick-400b-a17b", "gpu-mi300x", 8)
    cfg, _, _, _ = _configs(SCENARIOS["faults"], setups)
    tcfg, _, _, _ = _configs(SCENARIOS["faults"], setups,
                             traj_backend="torch", device="cpu")
    want = tsim.simulate(tr, cfg, engine="fleet")
    got = tsim.simulate(tr, tcfg, engine="fleet")
    assert got.accounting() == want.accounting()
    assert want.accounting()["completed"] > 100
    assert got.n_events == want.n_events
    for k in ("rid", "replica", "retries", "shed", "shed_reason"):
        np.testing.assert_array_equal(got.req[k], want.req[k])
    for k in ("first_token_s", "done_s", "shed_s"):
        np.testing.assert_allclose(got.req[k], want.req[k], rtol=0,
                                   atol=MOE_ATOL_S)
    np.testing.assert_allclose(got.step_arrays["duration_s"],
                               want.step_arrays["duration_s"], rtol=0,
                               atol=MOE_ATOL_S)
    assert_sim_invariants(got, tr)


def test_torch_backend_needs_a_card_unless_told_cpu(traces, monkeypatch):
    tr, _ = traces
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tsim.SimConfig(setup=_setups()[0], traj_backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.simulate(tr, cfg, engine="fleet")
    with pytest.raises(KeyError, match="numpy, torch"):
        tsim.simulate(tr, tsim.SimConfig(setup=_setups()[0],
                                         traj_backend="jax"), engine="fleet")
    with pytest.raises(ValueError, match="bucket_s"):
        tsim.simulate(tr, tsim.SimConfig(setup=_setups()[0], bucket_s=0.0),
                      engine="fleet")
    with pytest.raises(KeyError, match="unknown engine"):
        tsim.simulate(tr, tsim.SimConfig(setup=_setups()[0]), engine="x")


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_obs_hook_is_accepted_and_traces_as_the_reference(engine, traces):
    """``SimConfig(obs=...)`` is taken as the reference takes it: a span
    for each sampled request, the step log held to ``max_steps`` with
    the drops counted, and no spans when ``obs`` is disabled; spans,
    steps and drops equal the reference's."""
    tr, jtr = traces
    setup, jsetup = _setups()
    for kw in (dict(sample_rate=0.5, max_steps=300), dict(enabled=False)):
        res = tsim.simulate(tr, tsim.SimConfig(
            setup=setup, n_replicas=2, bucket_s=0.25, obs=ObsConfig(**kw)),
            engine=engine)
        jres = jsim.simulate(jtr, jsim.SimConfig(
            setup=jsetup, n_replicas=2, bucket_s=0.25,
            obs=JaxObsConfig(**kw)), engine=engine)
        assert res.steps_dropped == jres.steps_dropped
        assert res.faults_dropped == jres.faults_dropped == 0
        _same_obj(res.step_totals, jres.step_totals)
        if kw.get("enabled", True):
            assert 0 < res.spans.n < res.spans.n_source == len(tr)
            assert res.steps_dropped == res.step_totals["n"] - 300 > 0
            assert res.spans.tenant.tolist() == jres.spans.tenant.tolist()
            for k in ("rid", "replica", "first_token_s", "done_s", "shed"):
                assert getattr(res.spans, k).tobytes() == \
                    getattr(jres.spans, k).tobytes(), k
        else:
            assert res.spans is None and jres.spans is None
            assert res.steps_dropped == 0


def _same_windows(got, want):
    assert [tuple(vars(w).values()) for w in got] == \
        [tuple(vars(w).values()) for w in want]


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_adapter_windows_and_rows_bit_equal(engine, traces):
    tr, jtr = traces
    cfg, jcfg, _, _ = _configs(SCENARIOS["faults"], _setups())
    res = tsim.simulate(tr, cfg, engine=engine)
    jres = jsim.simulate(jtr, jcfg, engine=engine)
    for window_s, min_c in ((2.0, 2), (5.0, 1), (0.7, 3)):
        _same_windows(tad.summarize_windows(res, window_s, min_c),
                      jad.summarize_windows(jres, window_s, min_c))
    if engine == "fleet":          # the fast path against the slow one
        slow = tad._accumulate_slow(res, 2.0, 25)
        fast = tad._accumulate_fast(res, 2.0, 25)
        for a, b in zip(slow, fast):
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-9)
    got = tad.windows_to_dataset(res, _setups()[0], "llama3.1-8b",
                                 window_s=4.0)
    want = jad.windows_to_dataset(jres, _setups()[1], "llama3.1-8b",
                                  window_s=4.0)
    assert list(got.cols) == list(want.cols) and len(got) == len(want) > 0
    for k in want.cols:
        assert got[k].tobytes() == want[k].tobytes(), k
    assert tad.TRACE_BACKEND == jad.TRACE_BACKEND
    with pytest.raises(ValueError, match="window_s"):
        tad.summarize_windows(res, 0.0)
    with pytest.raises(ValueError, match="rows would be keyed"):
        tad.windows_to_dataset(res, _setups(hw="gpu-h100-sxm")[0], "m")


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_adapter_by_hardware_bit_equal(engine, traces):
    tr, jtr = traces
    cfg, jcfg, _, _ = _configs(SCENARIOS["mixed-hardware"], _setups())
    res = tsim.simulate(tr, cfg, engine=engine)
    jres = jsim.simulate(jtr, jcfg, engine=engine)
    with pytest.raises(ValueError, match="heterogeneous"):
        tad.windows_to_dataset(res, _setups()[0], "m")
    setups = {s.hw.name: s for s in cfg.slot_setups()}
    jsetups = {s.hw.name: s for s in jcfg.slot_setups()}
    got = tad.windows_to_datasets_by_hardware(res, setups, "llama3.1-8b",
                                              window_s=4.0)
    want = jad.windows_to_datasets_by_hardware(jres, jsetups, "llama3.1-8b",
                                               window_s=4.0)
    assert list(got) == list(want)
    for hw in want:
        for k in want[hw].cols:
            assert got[hw][k].tobytes() == want[hw][k].tobytes(), (hw, k)
