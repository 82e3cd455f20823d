"""The readers of the program's phase spans on a synthetic trace and
store: a decode step's device time split by the phases of its graph's
nodes, nothing read where a replay's events are not its nodes one for one
or the run has no graph, the prefill's CUDA-event spans summed by phase,
and nothing read from a program without phase spans."""
import sys
import types

import pytest

from _perfbench_cells import REPO
from perfbench import devtrace, harness
from repro_torch import phases

LABELS = ("embed", "norm", "attn.proj", "attn.kernel", "norm", "ffn",
          "norm", "head", "sample", "unlabelled")
# us a node takes; the decode trio reads 3 + 4 = 7 (attention), 5 (FFN)
# and 1 + 2 + 6 + 8 + 9 + 10 + 2 = 38 (the rest) a step
DURATIONS = (1, 2, 3, 4, 6, 5, 8, 9, 10, 2)
GRAPH = ("attn_ms.decode", "ffn_ms.decode", "rest_ms.decode")
SPANS = ("attn_ms.prefill", "ffn_ms.prefill", "moe_dispatch_ms.prefill")


def _replay(corr, at, order=None):
    """A replay's device events, one a node, shuffled by ``order``."""
    events, t = [], at
    for name, ns in zip(LABELS, DURATIONS):
        events.append((f"kernel_{name}", t, t + ns * 1000, corr))
        t += ns * 1000 + 500
    return [events[i] for i in order] if order else events


def _run(replays, oo, bb=4, prefill_events=()):
    device = [ev for r in replays for ev in r] + list(prefill_events)
    trace = devtrace.Trace(window=(0, 10 ** 9), device=device, host=[],
                           graph_corr=frozenset(r[0][3] for r in replays))
    return types.SimpleNamespace(trace=trace,
                                 traced=dict(ii=8, oo=oo, bb=bb))


@pytest.fixture
def store(monkeypatch):
    s = phases.Store()
    s.node_phases, s.signature = LABELS, (4, 64)
    monkeypatch.setattr(phases, "STORE", s)
    return s


def _read(metric, run):
    return harness.reader(REPO, metric)(run)


def test_decode_time_is_split_by_the_nodes_phases(store):
    order = [9, 3, 0, 5, 1, 8, 2, 7, 4, 6]
    run = _run([_replay(7, 0, order), _replay(8, 10 ** 6)], oo=3,
               prefill_events=[("gemm", 10 ** 7, 2 * 10 ** 7, 3)])
    got = [_read(m, run) for m in GRAPH]
    assert got == pytest.approx([7e-3, 5e-3, 38e-3])
    assert sum(got) == pytest.approx(sum(DURATIONS) * 1e-3)


@pytest.mark.parametrize("fault", ["an event lost", "an event more",
                                   "a replay lost", "another batch",
                                   "no labels"])
def test_nothing_is_read_where_replays_are_not_the_graph(store, fault):
    replays = [_replay(7, 0), _replay(8, 10 ** 6)]
    if fault == "an event lost":
        replays[1] = replays[1][:-1]
    elif fault == "an event more":
        replays[0] = replays[0] + [("memset", 9 * 10 ** 5, 10 ** 6, 7)]
    elif fault == "a replay lost":
        replays = replays[:1]
    elif fault == "another batch":
        store.signature = (8, 64)
    else:
        store.node_phases = None
    run = _run(replays, oo=3)
    assert [_read(m, run) for m in GRAPH] == [None] * 3


def test_a_run_without_a_graph_reads_nothing(store):
    """The CPU: no graph launches, and spans without device time."""
    run = _run([], oo=3, prefill_events=[("mm", 0, 10, 1)])
    store.spans = [phases.Span("ffn", "engine.prefill", 0.0, 1.0, None)]
    assert [_read(m, run) for m in GRAPH + SPANS] == [None] * 6
    run.trace = None
    assert [_read(m, run) for m in GRAPH + SPANS] == [None] * 6


def _span(name, ms, within="engine.prefill"):
    return phases.Span(name, within, 0.0, 1.0, ms)


def test_the_prefill_spans_are_summed_by_phase(store):
    store.spans = [_span("embed", 0.5), _span("norm", 1.0),
                   _span("attn.proj", 2.0), _span("attn.kernel", 3.0),
                   _span("moe.route", 0.25), _span("moe.dispatch", 4.0),
                   _span("moe.experts", 20.0), _span("moe.combine", 5.0),
                   _span("head", 1.5), _span("sample", 0.125),
                   _span("ffn", 100.0, within="engine.decode"),
                   _span("moe.dispatch", 50.0, within="engine.upload")]
    run = _run([], oo=1)
    assert [_read(m, run) for m in SPANS] == [5.0, 29.25, 9.25]


def test_a_model_without_experts_dispatches_nothing(store):
    store.spans = [_span("attn.kernel", 3.0), _span("ffn", 7.0)]
    assert _read("moe_dispatch_ms.prefill", _run([], oo=1)) == 0.0


def test_a_program_without_phase_spans_reads_nothing(store, monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "phases")
    monkeypatch.setitem(sys.modules, "repro_torch.phases", None)
    store.spans = [_span("ffn", 7.0)]
    run = _run([_replay(7, 0), _replay(8, 10 ** 6)], oo=3)
    assert [_read(m, run) for m in GRAPH + SPANS] == [None] * 6
