"""The port's span tracing (``obs/tracing.py``) and the engines' ``obs``
hook against the JAX package's, on one seeded smoke fleet trace with a
fault plan (``_torch_obs_cases``): shed requests, retries and crash
instants all occur.  Held bit for bit: ``_keep_mask``, ``ObsConfig``,
every ``SpanTable`` column of heap and fleet results at sample rates 1,
0.3 and 0, ``span_stats``, ``span_hists`` (whole and per-tenant shards,
merged quantiles), ``queue_depth_series``, and under step and fault
ring caps the dropped counts, the retained steps and the lossless step
totals, with the fleet engine's compaction firing several times.  The
``"torch"`` trajectories on the CPU give numpy's spans.  The
reference's ``tests/_sim_invariants.py`` runs on every traced result,
and its ``float64-edges`` rule on the port's ``obs/metrics.py`` and
``obs/tracing.py``, which the rule's own scope leaves out."""
import ast
import dataclasses

import numpy as np
import pytest
import torch

import _torch_obs_cases as cases
from _torch_obs_cases import same_array, same_float, same_obj
from _sim_invariants import assert_sim_invariants
from repro.obs import tracing as jtr_mod
from repro.obs.metrics import StreamHist as JaxStreamHist
from repro.serving import simulator as jsim
from repro.staticcheck.rules.float64_edges import RULE as FLOAT64_EDGES

from repro_torch.obs import tracing as ttr
from repro_torch.obs.metrics import StreamHist
from repro_torch.serving import simulator as tsim
from repro_torch.serving.fleet import VectorFleetSimulator

SPAN_COLS = ("rid", "tenant", "replica", "ii", "oo", "arrival_s",
             "first_token_s", "done_s", "shed_s", "retries", "shed",
             "shed_reason")
# small enough that the fleet engine compacts its step buffers many times
MAX_STEPS = 400
MAX_FAULTS = 5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def traces():
    return cases.traces()


_RUNS = {}


def _run(traces, engine, obs, **extra):
    """(port result, reference result), cached across tests."""
    key = (engine, obs is None, tuple(sorted((obs or {}).items())),
           tuple(sorted(extra.items())))
    if key not in _RUNS:
        tr, jtr = traces
        cfg, jcfg = cases.configs(obs, **extra)
        _RUNS[key] = (tsim.simulate(tr, cfg, engine=engine),
                      jsim.simulate(jtr, jcfg, engine=engine))
    return _RUNS[key]


def _same_spans(got, want):
    assert type(got).__name__ == "SpanTable"
    for k in SPAN_COLS:
        same_array(getattr(got, k), getattr(want, k), k)
    same_float(got.sample_rate, want.sample_rate)
    assert got.n_source == want.n_source and got.n == want.n
    for f in ("ttft_s", "e2e_s", "decode_s", "tpot_s"):
        same_array(getattr(got, f)(), getattr(want, f)(), f)


def _same_hist(got, want):
    assert isinstance(got, StreamHist) and isinstance(want, JaxStreamHist)
    same_array(got.inner_edges, want.inner_edges, "inner_edges")
    same_array(got.counts, want.counts, "counts")
    for k in ("n_inf", "n_neg_inf", "n_nan"):
        same_float(getattr(got, k), getattr(want, k))
    for q in (0.0, 10.0, 50.0, 90.0, 95.0, 99.0, 100.0):
        same_float(got.quantile(q), want.quantile(q))


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
def test_keep_mask_bit_equal(rate, seed):
    rng = np.random.default_rng(seed)
    for rid in (np.arange(5000, dtype=np.int64),
                rng.integers(0, 2**62, 5000, dtype=np.int64)):
        got = ttr._keep_mask(rid, rate, seed)
        want = jtr_mod._keep_mask(rid, rate, seed)
        same_array(got, want)
    if 0.0 < rate < 1.0:
        assert abs(got.mean() - rate) < 0.05


def test_obs_config_fields_and_defaults():
    got = [(f.name, f.type, f.default) for f in
           dataclasses.fields(ttr.ObsConfig)]
    want = [(f.name, f.type, f.default) for f in
            dataclasses.fields(jtr_mod.ObsConfig)]
    assert got == want
    assert ttr.ObsConfig() == ttr.ObsConfig(**dataclasses.asdict(
        jtr_mod.ObsConfig()))


@pytest.mark.parametrize("rate", [1.0, 0.3, 0.0])
@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_spans_bit_equal(engine, rate, traces):
    res, jres = _run(traces, engine, dict(sample_rate=rate, sample_seed=5))
    _same_spans(res.spans, jres.spans)
    same_obj(ttr.span_stats(res.spans), jtr_mod.span_stats(jres.spans))
    # the scenario holds what spans must carry
    every = ttr.record_spans(res, ttr.ObsConfig())
    assert every.shed.any() and every.retries.sum() > 0
    assert {e.kind for e in res.fault_log} == {"crash", "restore"}
    if rate == 0.0:
        assert res.spans.n == 0 and res.spans.n_source == len(traces[0])
    elif rate < 1.0:
        assert 0 < res.spans.n < res.spans.n_source == len(traces[0])
    else:
        assert res.spans.n == len(traces[0])
    # derived post-run: the same table from the finished result
    _same_spans(ttr.record_spans(res, ttr.ObsConfig(sample_rate=rate,
                                                    sample_seed=5)),
                res.spans)
    assert_sim_invariants(res, traces[0])


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_span_hists_and_queue_depth_bit_equal(engine, traces):
    res, jres = _run(traces, engine, {})
    t, jt_ = res.spans, jres.spans
    for n_bins in (48, 16):
        got = ttr.span_hists(t, n_bins=n_bins)
        want = jtr_mod.span_hists(jt_, n_bins=n_bins)
        assert list(got) == list(want) == ["ttft_s", "tpot_s", "e2e_s"]
        for k in want:
            _same_hist(got[k], want[k])
        got = ttr.span_hists(t, n_bins=n_bins, by=t.tenant)
        want = jtr_mod.span_hists(jt_, n_bins=n_bins, by=jt_.tenant)
        assert list(got) == list(want) == ["chat", "generate", "summarize"]
        for k in want:
            _same_hist(got[k], want[k])
        merged = StreamHist.merged(got.values())
        _same_hist(merged, JaxStreamHist.merged(want.values()))
        assert merged.total == t.n
    for kw in (dict(bucket_s=0.5, t_end=res.sim_end_s), dict(bucket_s=1.0),
               dict(bucket_s=0.25, t_end=20.0)):
        got = ttr.queue_depth_series(t, **kw)
        want = jtr_mod.queue_depth_series(jt_, **kw)
        assert list(got) == list(want)
        for k in want:
            same_array(got[k], want[k], k)
    empty = t.select(np.zeros(t.n, bool))
    got, want = ttr.queue_depth_series(empty), \
        jtr_mod.queue_depth_series(jt_.select(np.zeros(jt_.n, bool)))
    for k in want:
        same_array(got[k], want[k], k)


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_obs_disabled_or_absent_records_no_spans(engine, traces):
    for obs in (None, dict(enabled=False)):
        res, jres = _run(traces, engine, obs)
        assert res.spans is None and jres.spans is None
        assert (res.steps_dropped, res.faults_dropped) == (0, 0)
        same_obj(res.step_totals, jres.step_totals)
        assert len(res.steps) == res.step_totals["n"]


def _count_compactions(sim):
    """Wrap ``sim._maybe_compact`` to count the calls that fold."""
    n = [0]
    inner = sim._maybe_compact

    def counted():
        before = sim._comp_steps
        inner()
        n[0] += sim._comp_steps is not before

    sim._maybe_compact = counted
    return n


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_fleet_step_cap_compacts_and_matches_the_reference(backend,
                                                            traces):
    tr, _ = traces
    obs = dict(max_steps=MAX_STEPS, max_fault_events=MAX_FAULTS)
    cfg, _ = cases.configs(obs, traj_backend=backend, device="cpu")
    sim = VectorFleetSimulator(tr, cfg)
    n_compact = _count_compactions(sim)
    res = sim.run()
    _, jres = _run(traces, "fleet", obs)
    full, _ = _run(traces, "fleet", {})
    assert n_compact[0] >= 3
    assert res.steps_dropped == jres.steps_dropped == \
        full.step_totals["n"] - MAX_STEPS
    assert res.faults_dropped == jres.faults_dropped == \
        len(full.fault_log) - MAX_FAULTS > 0
    assert [(e.t, e.kind, e.replica, e.n_displaced)
            for e in res.fault_log] == \
        [(e.t, e.kind, e.replica, e.n_displaced) for e in jres.fault_log]
    assert list(res.step_arrays) == list(jres.step_arrays)
    for k in jres.step_arrays:
        same_array(res.step_arrays[k], jres.step_arrays[k], k)
        # the retained window is the newest MAX_STEPS of the uncapped run
        same_array(res.step_arrays[k], full.step_arrays[k][-MAX_STEPS:], k)
    # compaction leaves the lossless totals and every request alone
    same_obj(res.step_totals, jres.step_totals)
    same_obj(res.step_totals, full.step_totals)
    for k in full.req:
        same_array(res.req[k], full.req[k], k)
    _same_spans(res.spans, full.spans)
    assert_sim_invariants(res, tr)


def test_heap_step_cap_matches_the_reference(traces):
    obs = dict(max_steps=MAX_STEPS, max_fault_events=MAX_FAULTS)
    res, jres = _run(traces, "heap", obs)
    full, _ = _run(traces, "heap", {})
    assert len(res.steps) == MAX_STEPS
    assert res.steps_dropped == jres.steps_dropped == \
        full.step_totals["n"] - MAX_STEPS
    assert res.faults_dropped == jres.faults_dropped == \
        len(full.fault_log) - MAX_FAULTS > 0

    def steps(r):
        return [(s.t_end, s.replica, s.kind, s.bb, s.duration_s,
                 s.tokens_out) for s in r.steps]

    assert steps(res) == steps(jres) == steps(full)[-MAX_STEPS:]
    assert [(e.t, e.kind, e.replica) for e in res.fault_log] == \
        [(e.t, e.kind, e.replica) for e in jres.fault_log]
    same_obj(res.step_totals, jres.step_totals)
    same_obj(res.step_totals, full.step_totals)
    _same_spans(res.spans, full.spans)
    assert_sim_invariants(res, traces[0])


@pytest.mark.parametrize("rate", [1.0, 0.3])
def test_torch_trajectories_give_numpys_spans(rate, traces):
    obs = dict(sample_rate=rate)
    got, _ = _run(traces, "fleet", obs, traj_backend="torch", device="cpu")
    want, _ = _run(traces, "fleet", obs)
    _same_spans(got.spans, want.spans)
    for k in want.step_arrays:
        same_array(got.step_arrays[k], want.step_arrays[k], k)


@pytest.mark.parametrize("name", ["metrics.py", "tracing.py"])
def test_float64_edges_contract_holds_in_the_port(name):
    """The reference's rule, applied to the port's copy of a contract
    module: every edge builder casts to float32."""
    import repro_torch.obs
    path = repro_torch.obs.__path__[0] + "/" + name
    text = open(path).read()
    found = FLOAT64_EDGES.check(ast.parse(text), text, "src/repro/obs/"
                                + name)
    assert found == []
    assert FLOAT64_EDGES.applies("src/repro/obs/" + name)
