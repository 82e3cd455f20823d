"""The port's phase spans (``repro_torch.phases``) on the CPU: with no
profiler a phase is the shared no-op context and the store stays empty;
a dense and a MoE smoke model give the same bits of logits and tokens
traced and untraced; under ``torch.profiler`` each phase the model runs
is a host range inside ``engine.prefill`` or ``engine.decode``, as many
times a forward as its layers run it; the capture's node labelling maps
boundary counts to labels; phases stay flat; and every ``phase`` and
``span`` call in the port names a phase or an engine range; a range a
layer holds each layer's phases."""
import ast
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import phases
from repro_torch.configs import get_smoke_config
from repro_torch.inference.engine import ServingEngine
from repro_torch.models.transformer import Model

REPO = Path(__file__).resolve().parents[1]
ARCHS = {"dense": "llama3.1-8b", "moe": "phi3.5-moe-42b-a6.6b"}
FFN = {"dense": ("ffn",),
       "moe": ("moe.route", "moe.dispatch", "moe.experts", "moe.combine")}


def _model(kind):
    cfg = get_smoke_config(ARCHS[kind])
    return Model(cfg).init(torch.Generator().manual_seed(0))


def _prompts(cfg):
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 7))


def _serve(model, prompts, oo):
    """(prefill logits, each decode step's logits, the engine's tokens)."""
    tokens = torch.as_tensor(prompts)
    logits, cache = model.prefill(tokens, prompts.shape[1] + oo)
    steps, tok = [], logits[:, -1].argmax(-1, keepdim=True)
    for _ in range(oo - 1):
        step, cache = model.decode_step(cache, tok)
        steps.append(step)
        tok = step[:, -1].argmax(-1, keepdim=True)
    res = ServingEngine(model, device="cpu").generate(prompts, oo)
    return logits, steps, res.tokens


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_tracing_changes_no_bit_and_off_records_nothing(kind):
    model = _model(kind)
    prompts = _prompts(model.cfg)
    assert phases.phase("norm") is phases.phase("ffn") is phases._OFF
    assert phases.span("engine.decode") is phases._OFF
    phases.STORE.spans = []
    off = _serve(model, prompts, 4)
    assert phases.STORE.spans == []
    with profile(activities=[ProfilerActivity.CPU]):
        on = _serve(model, prompts, 4)
    assert phases.STORE.spans
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in zip(off[1], on[1]))
    np.testing.assert_array_equal(off[2], on[2])


def _forward_counts(kind, n_layers, prefill):
    """Each phase's count in one forward: two norms a layer and the first
    one, the q/k/v and the o projections, one attention (and, in a
    prefill, the K/V write), the layer's FFN phases."""
    want = {"embed": 1, "norm": 2 * n_layers + 1, "attn.proj": 2 * n_layers,
            "attn.kernel": (2 if prefill else 1) * n_layers, "head": 1,
            "sample": 1}
    want.update({name: n_layers for name in FFN[kind]})
    return want


@pytest.mark.parametrize("kind", sorted(ARCHS))
def test_every_phase_runs_in_an_engine_range(kind):
    model = _model(kind)
    prompts, oo = _prompts(model.cfg), 3
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ServingEngine(model, device="cpu").generate(prompts, oo)
    events = [e for e in prof.events()
              if e.name in phases.PHASES or e.name in phases.ENGINE]
    ranges = {e.name: e.time_range for e in events
              if e.name in phases.ENGINE}
    assert set(ranges) == {"engine.upload", "engine.prefill",
                           "engine.decode", "engine.tokens_out"}
    seen = Counter()
    for e in events:
        if e.name in phases.PHASES:
            within = [n for n, r in ranges.items()
                      if r.start <= e.time_range.start
                      and e.time_range.end <= r.end]
            assert len(within) == 1, (e.name, within)
            seen[within[0], e.name] += 1
    n = model.cfg.n_layers
    want = Counter({("engine.prefill", k): v
                    for k, v in _forward_counts(kind, n, True).items()})
    want.update({("engine.decode", k): v * (oo - 1)
                 for k, v in _forward_counts(kind, n, False).items()})
    assert seen == want
    layers = Counter(
        n for e in prof.events() if e.name == phases.LAYER
        for n, r in ranges.items()
        if r.start <= e.time_range.start and e.time_range.end <= r.end)
    assert layers == {"engine.prefill": n, "engine.decode": n * (oo - 1)}
    spans = phases.STORE.spans
    assert Counter((s.within, s.name) for s in spans) == want
    assert all(s.device_ms is None and s.host_end >= s.host_start
               for s in spans)


@pytest.mark.parametrize("marks,kinds,want", [
    ([("embed", 0, 1), ("norm", 1, 4), ("ffn", 5, 7)],
     [0, 0, 5, 1, 0, 2, 0, 7, 0],
     ("embed", "norm", "norm", "unlabelled", "ffn", "ffn", "unlabelled")),
    ([], [0, 2, 1], ("unlabelled",) * 3),
    ([("head", 0, 0), ("sample", 0, 3)], [7, 0, 3], ("sample",)),
    ([("attn.kernel", 2, 3)], [0, 0, 0, 0],
     ("unlabelled", "unlabelled", "attn.kernel", "unlabelled")),
])
def test_label_nodes_maps_boundary_counts(marks, kinds, want):
    assert phases.label_nodes(marks, kinds) == want


def test_label_nodes_refuses_a_mark_past_the_graph():
    with pytest.raises(ValueError, match="marks nodes"):
        phases.label_nodes([("ffn", 2, 5)], [0, 0, 0])


def test_a_phase_inside_a_phase_is_refused_when_traced():
    with profile(activities=[ProfilerActivity.CPU]):
        with phases.phase("ffn"):
            with pytest.raises(RuntimeError, match="phases are flat"):
                with phases.phase("norm"):
                    pass
        with phases.phase("norm"):   # the first closed, the next opens
            pass


def _calls(tree, fn):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call) and (
        getattr(n.func, "id", None) == fn
        or getattr(n.func, "attr", None) == fn)]


def _phase_withs(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.With)
            and any(_calls(item.context_expr, "phase") for item in n.items)]


PORT = sorted(p for p in (REPO / "src" / "repro_torch").rglob("*.py")
              if p.name != "phases.py")


def test_every_phase_and_span_call_names_a_member():
    named = Counter()
    for path in PORT:
        tree = ast.parse(path.read_text(), str(path))
        for fn, members in (("phase", phases.PHASES),
                            ("span", phases.ENGINE)):
            for call in _calls(tree, fn):
                if fn == "span" and "phases" not in ast.unparse(call.func):
                    continue   # another module's span()
                arg = call.args[0] if call.args else None
                assert isinstance(arg, ast.Constant) and arg.value in \
                    members, f"{path}:{call.lineno}: {ast.unparse(call)}"
                named[arg.value] += 1
    assert set(named) == set(phases.PHASES) | set(phases.ENGINE)


def test_no_phase_nests_in_another():
    for path in PORT:
        tree = ast.parse(path.read_text(), str(path))
        for outer in _phase_withs(tree):
            inner = [w for stmt in outer.body for w in _phase_withs(stmt)]
            assert not inner, f"{path}:{inner[0].lineno} nests in " \
                              f"{outer.lineno}"
