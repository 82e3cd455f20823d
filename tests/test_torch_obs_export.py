"""The port's telemetry export (``obs/export.py``) against the JAX
package's, on the seeded smoke fleet trace with a fault plan of
``_torch_obs_cases`` under a ``StaticPolicy`` (so that the trace holds
replica steps, crash and restore instants, control instants and request
spans of every kind): ``chrome_trace`` equal to the reference's dict
after a JSON round trip, for heap and fleet results, whole and
truncated, with the spans given and taken from the result;
``write_chrome_trace`` and ``write_jsonl`` write the reference's bytes
(``inf`` and ``nan`` fields included) and return its counts;
``spans_to_dicts`` and ``scorecard_markdown`` are equal."""
import json

import numpy as np
import pytest
import torch

import _torch_obs_cases as cases
from repro.obs import calibration as jcal
from repro.obs import export as jex
from repro.serving import simulator as jsim
from repro.serving.autoscaler import StaticPolicy as JaxStatic

from repro_torch.obs import calibration as tcal
from repro_torch.obs import export as tex
from repro_torch.obs.tracing import ObsConfig, record_spans
from repro_torch.serving import simulator as tsim
from repro_torch.serving.autoscaler import StaticPolicy

# (max_step_events, max_span_events): whole, then both truncated
CAPS = ((10 ** 9, 10 ** 9), (20000, 5000), (300, 40))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def results():
    """engine -> (port result, reference result), traced at rate 0.5."""
    tr, jtr = cases.traces()
    out = {}
    for engine in ("heap", "fleet"):
        cfg, jcfg = cases.configs(dict(sample_rate=0.5),
                                  control_interval_s=5.0)
        out[engine] = (
            tsim.simulate(tr, cfg, StaticPolicy(n_replicas=3, batch_cap=16),
                          engine=engine),
            jsim.simulate(jtr, jcfg, JaxStatic(n_replicas=3, batch_cap=16),
                          engine=engine))
    return out


def _round_trip(doc):
    return json.loads(json.dumps(doc))


@pytest.mark.parametrize("caps", CAPS)
@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_chrome_trace_equals_the_references(engine, caps, results):
    res, jres = results[engine]
    steps, spans = caps
    got = tex.chrome_trace(res, max_step_events=steps,
                           max_span_events=spans)
    want = jex.chrome_trace(jres, max_step_events=steps,
                            max_span_events=spans)
    assert _round_trip(got) == _round_trip(want)
    meta = got["metadata"]
    assert meta["n_spans_total"] == res.spans.n > 0
    truncated = meta["n_steps_emitted"] < meta["n_steps_total"]
    assert truncated == (steps < meta["n_steps_total"])
    phases = {e["ph"] for e in got["traceEvents"]}
    assert {"M", "X", "i", "b", "e", "n"} <= phases
    pids = {e["pid"] for e in got["traceEvents"] if e["ph"] == "i"}
    assert pids == {0, 2}           # crash/restore and control instants


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_chrome_trace_of_given_spans_and_written_bytes(engine, results,
                                                       tmp_path):
    res, jres = results[engine]
    from repro.obs.tracing import ObsConfig as JaxObsConfig
    from repro.obs.tracing import record_spans as jax_record_spans
    spans = record_spans(res, ObsConfig(sample_rate=0.2, sample_seed=9))
    jspans = jax_record_spans(jres, JaxObsConfig(sample_rate=0.2,
                                                 sample_seed=9))
    got = tex.chrome_trace(res, spans=spans, max_span_events=50)
    want = jex.chrome_trace(jres, spans=jspans, max_span_events=50)
    assert _round_trip(got) == _round_trip(want)
    a = tex.write_chrome_trace(res, tmp_path / "port.json", spans=spans,
                               max_step_events=500)
    b = jex.write_chrome_trace(jres, tmp_path / "ref.json", spans=jspans,
                               max_step_events=500)
    assert a.name == "port.json" and a.read_bytes() == b.read_bytes()


@pytest.mark.parametrize("engine", ["heap", "fleet"])
def test_spans_to_dicts_and_jsonl_bytes(engine, results, tmp_path):
    res, jres = results[engine]
    got, want = tex.spans_to_dicts(res.spans), jex.spans_to_dicts(jres.spans)
    assert got == want and len(got) == res.spans.n
    assert any(d["shed"] for d in got) and any("done_s" in d for d in got)
    n = tex.write_jsonl(got, tmp_path / "port.jsonl")
    jn = jex.write_jsonl(want, tmp_path / "ref.jsonl")
    assert n == jn == len(got)
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()


def _audits():
    """The same audit on both sides, with inf/nan fields and numpy
    scalars, whose JSONL takes every ``_jsonable`` branch."""
    out = []
    for m in (tcal, jcal):
        a = m.CalibrationAudit()
        rng = np.random.default_rng(2)
        for i in range(20):
            conf = i / 20.0
            a.tick(float(i), predicted=100.0 + (5.0 if conf > 0.5 else 60.0),
                   measured=100.0, confidence=conf,
                   pred_err=float(rng.uniform(5.0, 50.0)))
        a.tick(20.0, predicted=float("nan"), measured=100.0, confidence=0.1)
        a.event(21.0, "degradation", reason="backoff",
                n=np.int64(3), x=np.float32(0.25), y=float("-inf"))
        out.append(a)
    return out


def test_audit_jsonl_and_scorecard(tmp_path, results):
    audit, jaudit = _audits()
    n = tex.write_jsonl(audit.events, tmp_path / "port.jsonl")
    jn = jex.write_jsonl(jaudit.events, tmp_path / "ref.jsonl")
    assert n == jn == 22
    text = (tmp_path / "port.jsonl").read_text()
    assert text == (tmp_path / "ref.jsonl").read_text()
    assert '"ape": "inf"' in text and '"y": "-inf"' in text
    res, jres = results["fleet"]
    slo = cases.fleet_config(cases.tt).slo_map
    meta = {k: v for k, v in res.meta_metrics(slo).items()
            if k != "per_tenant"}
    jmeta = {k: v for k, v in jres.meta_metrics(slo).items()
             if k != "per_tenant"}
    for kw, jkw in (
            (dict(meta=meta, per_tenant=res.per_tenant(slo),
                  calibration=audit.summary()),
             dict(meta=jmeta, per_tenant=jres.per_tenant(slo),
                  calibration=jaudit.summary())),
            (dict(calibration=audit.summary(), title="t"),
             dict(calibration=jaudit.summary(), title="t")),
            (dict(), dict())):
        got = tex.scorecard_markdown(**kw)
        assert got == jex.scorecard_markdown(**jkw)
    assert "Reliability curve" in tex.scorecard_markdown(
        calibration=audit.summary())
