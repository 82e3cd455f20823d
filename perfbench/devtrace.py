"""The benchmark's one profiler helper: traces a call with torch.profiler
and reduces the trace to what the per-layer readers and the result's
``device`` and ``breakdown`` take.

A copy of the way ``chip_smoke.py``'s ``device_ms`` and ``_device_profile``
trace: the tracer runs a first round as its warm-up and keeps the second (a
trace that starts with the call can lose the first kernels' records), and
a step's device marks are no device work.  The kernel kinds are
``chip_smoke.py``'s ``STEP_KINDS`` with K2 beside them.  A kernel launched
by a CUDA graph shares the correlation id of the host's graph launch, which
is how a decode step's kernels are told from the prefill's.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import torch

WINDOW = "perfbench.traced_request"
KINDS = (("K1", ("rmsnorm",)), ("K2", ("flash_fwd",)),
         ("K3", ("decode_attn",)),
         ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
         ("sort", ("sort", "radix")),
         ("gather/scatter", ("index", "scatter", "gather")))
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
NAMED_GAPS = 2000     # longest idle gaps attributed one by one
NAME_CHARS = 96


def kind_keys(kind: str) -> Tuple[str, ...]:
    return dict(KINDS)[kind]


def _ns(e, what: str) -> int:
    fn = getattr(e, f"{what}_ns", None)
    return fn() if fn else int(getattr(e, f"{what}_us")() * 1000)


@dataclasses.dataclass
class Trace:
    window: Tuple[int, int]                 # ns, the traced request
    device: List[Tuple[str, int, int, int]]  # name, start, end, correlation
    host: List[Tuple[str, int, int]]         # name, start, end; by start
    graph_corr: frozenset                    # correlations of graph launches

    @classmethod
    def of(cls, events) -> "Trace":
        from torch.autograd import DeviceType
        device, host, graph, window = [], [], set(), None
        for e in events:
            name = e.name()
            start = _ns(e, "start")
            end = start + _ns(e, "duration")
            act = getattr(e, "activity_type", lambda: None)()
            if e.device_type() == DeviceType.CUDA:
                if name.startswith("ProfilerStep") or name == WINDOW:
                    continue
                if act is not None and act not in DEVICE_ACTIVITIES:
                    continue
                device.append((name, start, end, e.correlation_id()))
            elif name == WINDOW:
                window = (start, end)
            elif not name.startswith("ProfilerStep"):
                host.append((name, start, end))
                if "GraphLaunch" in name:
                    graph.add(e.correlation_id())
        host.sort(key=lambda h: h[1])
        if window is None:
            raise RuntimeError(f"the trace holds no {WINDOW!r} range")
        device = [d for d in device if d[2] > window[0] and d[1] < window[1]]
        return cls(window, device, host, frozenset(graph))

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def select(self, keys: Optional[Tuple[str, ...]] = None,
               phase: Optional[str] = None):
        """Device events whose names hold one of ``keys`` (all without),
        of ``phase``: 'decode' (launched by a graph), 'prefill' (not)."""
        out = []
        for ev in self.device:
            if keys is not None and not any(k in ev[0].lower() for k in keys):
                continue
            if phase is not None and (ev[3] in self.graph_corr) != (
                    phase == "decode"):
                continue
            out.append(ev)
        return out

    def device_s(self, keys=None, phase=None) -> float:
        return sum(e[2] - e[1] for e in self.select(keys, phase)) / 1e9

    def _busy(self) -> List[Tuple[int, int]]:
        lo, hi = self.window
        spans = sorted((max(s, lo), min(e, hi)) for _, s, e, _ in self.device)
        merged: List[List[int]] = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) / 1e9

    def gaps(self) -> List[Tuple[int, int]]:
        """The intervals of the window in which nothing ran on the device."""
        out, at = [], self.window[0]
        for s, e in self._busy():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def _host_at(self, t: int) -> str:
        """The innermost host event running at ``t``: of those that hold it,
        the one that started last."""
        starts = [h[1] for h in self.host]
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if self.host[j][2] >= t:
                return self.host[j][0]
        return "no host event"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device operations that took most time, and the idle time by
        what the host was doing (the ``NAMED_GAPS`` longest gaps one by
        one, the rest together), each the ``top`` largest."""
        ops: Dict[str, float] = {}
        for name, s, e, _ in self.device:
            ops[name] = ops.get(name, 0.0) + (e - s) / 1e9
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        idle: Dict[str, float] = {}
        for s, e in gaps[:NAMED_GAPS]:
            name = self._host_at((s + e) // 2)
            idle[name] = idle.get(name, 0.0) + (e - s) / 1e9
        if len(gaps) > NAMED_GAPS:
            longest = (gaps[NAMED_GAPS][1] - gaps[NAMED_GAPS][0]) / 1e3
            rest = sum(e - s for s, e in gaps[NAMED_GAPS:]) / 1e9
            idle[f"{len(gaps) - NAMED_GAPS} shorter gaps, each "
                 f"<= {longest:.1f} us"] = rest

        def best(d):
            return [[k[:NAME_CHARS], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": best(ops), "idle_gaps": best(idle)}


def trace(warm: Callable[[], None], fn: Callable[[], object], device):
    """Runs ``warm`` as the tracer's warm-up round and ``fn`` as its kept
    round, inside the range ``WINDOW``; returns (Trace, fn's result)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    kept, out = [], None
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: kept.append(
                     p.profiler.kineto_results.events())) as prof:
        warm()
        sync()
        prof.step()
        with record_function(WINDOW):
            out = fn()
            sync()
        prof.step()
    return Trace.of(kept[-1]), out
