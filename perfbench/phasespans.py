"""What the readers of the program's phase spans share (the metrics
``attn_ms``, ``ffn_ms``, ``rest_ms`` and ``moe_dispatch_ms``).

The program labels each kernel, memset and memcpy node of its decode graph
with a phase when it captures it (``repro_torch.phases``:
``STORE.node_phases``, in node order), and keeps the CUDA-event spans of
the phases of its last profiled ``generate`` call (``STORE.spans``).  A
replay's device events, sorted by start, are its nodes in order; the
readers add up their durations by the node's phase.  A program without
these spans gives every reader nothing to read.
"""
from __future__ import annotations

import sys
from typing import Optional, Tuple

ATTN = ("attn.proj", "attn.kernel")
FFN = ("ffn", "moe.route", "moe.dispatch", "moe.experts", "moe.combine")
REST = ("embed", "norm", "head", "sample", "unlabelled")
DISPATCH = ("moe.route", "moe.dispatch", "moe.combine")


def _log(msg: str) -> None:
    print(f"[perfbench] {msg}", file=sys.stderr, flush=True)


def store():
    """The program's phase store, or None where the program has none."""
    try:
        from repro_torch import phases
    except ImportError:
        return None
    return phases.STORE


def decode_ms(run, names: Tuple[str, ...]) -> Optional[float]:
    """Device ms a decode step spends in the graph nodes labelled with one
    of ``names``, over the traced request's ``oo - 1`` replays; None where
    the run has no replay to read or a replay's events are not its nodes
    one for one."""
    t, x, st = run.trace, run.traced, store()
    if t is None or not t.graph_corr or x["oo"] < 2 or st is None:
        return None
    labels = st.node_phases
    if not labels or st.signature is None or st.signature[0] != x["bb"]:
        return None
    launches = {}
    for ev in t.device:
        if ev[3] in t.graph_corr:
            launches.setdefault(ev[3], []).append(ev)
    steps = x["oo"] - 1
    if len(launches) != steps:
        _log(f"phase spans: {len(launches)} graph launches traced, "
             f"{steps} replays run; nothing read")
        return None
    ns = 0
    for corr, events in launches.items():
        if len(events) != len(labels):
            _log(f"phase spans: a replay (correlation {corr}) ran "
                 f"{len(events)} device events, its graph has {len(labels)} "
                 f"labelled nodes; nothing read")
            return None
        events.sort(key=lambda e: e[1])
        ns += sum(e[2] - e[1] for e, lab in zip(events, labels)
                  if lab in names)
    return ns / 1e6 / steps


def prefill_ms(run, names: Tuple[str, ...]) -> Optional[float]:
    """Device ms of the traced request's prefill in the phases ``names``:
    the sum of their CUDA-event spans inside ``engine.prefill``; None
    where no span was kept or device time was not measured (the CPU)."""
    st = store()
    if run.trace is None or st is None:
        return None
    spans = [s for s in st.spans if s.within == "engine.prefill"]
    if not spans or any(s.device_ms is None for s in spans):
        return None
    return sum(s.device_ms for s in spans if s.name in names)
