"""Phase spans inside the port's model step and serving engine.

``phase(name)`` marks one piece of a forward with a name of ``PHASES``:

* **off**, where no profiler is active and no labelled capture runs (every
  benchmark window): one check of the flag ``torch.profiler`` sets, one of
  the capture flag, and the shared no-op context; nothing is allocated or
  recorded;
* under an active ``torch.profiler``: a range of that name among the
  trace's host events, on the clock of its device events; while a
  ``generate`` call records (``recording``), also a ``Span`` in ``STORE``
  with its host times and, on a card, a pair of CUDA events on the
  current stream, read as device ms when ``device_ms`` is first read,
  after the call (on the CPU device time is not measured: None);
* inside a labelled CUDA graph capture (``labelling``): the count of graph
  nodes captured so far, read from the driver at entry and exit;
  ``label_nodes`` turns those marks into one phase a kernel, memset and
  memcpy node.  Replays run no Python, so they pay nothing.

Phases are flat: none runs inside another.  ``span(name)`` opens the
engine's ranges (``ENGINE``), which hold phases, and ``layer()`` a range
``LAYER`` around each layer of a forward, phases and the code between
them, so that each instant of a forward lies in a range that began a few
hundred host events before it; both under the profiler alone.  All are
``RecordFunction`` ranges of the profiler's function scope
(``_RecordFunctionFast``), as an operator's: a ``record_function`` range
is a user annotation, for which the profiler also puts a twin among the
device events, spanning the kernels inside it and the idle time between
them, and a trace without activity types (torch 2.11) cannot tell that
twin from device work.

``STORE`` is process-global, as ``compiles.COUNTS``: the last labelled
capture's node phases and signature, and the last profiled ``generate``
call's spans.  The module imports only torch and ctypes of what is not
the standard library, so model code uses it without loading tooling.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import time
from typing import List, Optional, Sequence, Tuple

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

PHASES = ("embed", "norm", "attn.proj", "attn.kernel", "ffn", "moe.route",
          "moe.dispatch", "moe.experts", "moe.combine", "head", "sample")
UNLABELLED = "unlabelled"
ENGINE = ("engine.upload", "engine.capture", "engine.prefill",
          "engine.decode", "engine.tokens_out")
LAYER = "model.layer"
# CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET: the nodes a replay runs on
# the device, the three activity kinds a profiler's device trace holds
DEVICE_NODE_KINDS = (0, 1, 2)


class Span:
    """One run of a phase in a recorded ``generate`` call: its name (a
    member of ``PHASES``), the engine range it ran in, its host times
    (``time.perf_counter()``, s) and its device ms, from its CUDA events,
    read at the first look (the events are done once the call returned),
    or given; None where not measured."""
    __slots__ = ("name", "within", "host_start", "host_end", "_ms",
                 "_events")

    def __init__(self, name: str, within: Optional[str], host_start: float,
                 host_end: float, device_ms: Optional[float] = None,
                 events=None):
        self.name, self.within = name, within
        self.host_start, self.host_end = host_start, host_end
        self._ms, self._events = device_ms, events

    @property
    def device_ms(self) -> Optional[float]:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._ms, self._events = start.elapsed_time(end), None
        return self._ms


class Store:
    """What the last labelled capture and the last profiled ``generate``
    call left."""

    def __init__(self):
        self.node_phases: Optional[Tuple[str, ...]] = None
        self.signature: Optional[tuple] = None
        self.spans: List[Span] = []


STORE = Store()


# the context of a phase or range with nothing to record
_OFF = contextlib.nullcontext()


_rec: Optional["_Recording"] = None   # set while a generate call records
_marks: Optional[list] = None         # set while a labelled capture runs
_graph = None                         # the CUgraph under that capture
_open: Optional[str] = None           # the phase open now, where traced


def _enter(name: str) -> None:
    global _open
    if _open is not None:
        raise RuntimeError(f"phase {name!r} opened inside phase {_open!r}: "
                           f"phases are flat")
    _open = name


class _Profiled:
    """A phase under an active profiler."""
    __slots__ = ("name", "fn", "t0", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _enter(self.name)
        self.fn = _RecordFunctionFast(self.name)
        self.fn.__enter__()
        if _rec is not None:
            self.start = None
            if _rec.cuda:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record()
            self.t0 = time.perf_counter()
        return None

    def __exit__(self, *exc):
        global _open
        if _rec is not None:
            t1 = time.perf_counter()
            events = None
            if _rec.cuda:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                events = (self.start, end)
            _rec.spans.append(Span(self.name, _rec.within, self.t0, t1,
                                   events=events))
        self.fn.__exit__(*exc)
        _open = None
        return False


class _Marked:
    """A phase inside a labelled capture: the nodes captured in it."""
    __slots__ = ("name", "first")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _enter(self.name)
        self.first = node_count(_graph)
        return None

    def __exit__(self, *exc):
        global _open
        _marks.append((self.name, self.first, node_count(_graph)))
        _open = None
        return False


def phase(name: str):
    """The context of phase ``name`` (a member of ``PHASES``)."""
    if _marks is not None:
        return _Marked(name)
    if _profiler._is_profiler_enabled:
        return _Profiled(name)
    return _OFF


class _Range:
    """An engine range under an active profiler: the recorded phases in
    it take its name as ``within``."""
    __slots__ = ("name", "fn", "outer")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.fn = _RecordFunctionFast(self.name)
        self.fn.__enter__()
        if _rec is not None:
            self.outer, _rec.within = _rec.within, self.name
        return None

    def __exit__(self, *exc):
        if _rec is not None:
            _rec.within = self.outer
        self.fn.__exit__(*exc)
        return False


def span(name: str):
    """The context of the engine range ``name`` (a member of ``ENGINE``)."""
    if _profiler._is_profiler_enabled:
        return _Range(name)
    return _OFF


def layer():
    """The context of one layer of a forward (the range ``LAYER``)."""
    if _profiler._is_profiler_enabled:
        return _RecordFunctionFast(LAYER)
    return _OFF


class _Recording:
    """A profiled ``generate`` call: ``STORE.spans`` emptied at entry and
    set to the call's spans at exit.  Their device times are read later,
    where they are looked at: read here, the reading would idle the
    device inside the traced call."""

    def __init__(self, device: torch.device):
        self.cuda = torch.device(device).type == "cuda"
        self.within: Optional[str] = None   # the engine range open now
        self.spans: List[Span] = []

    def __enter__(self):
        global _rec
        STORE.spans = []
        _rec = self
        return None

    def __exit__(self, *exc):
        global _rec
        _rec = None
        if exc[0] is None:
            STORE.spans = self.spans
        return False


def recording(device):
    """The context of a ``generate`` call on ``device``: where a profiler
    is active, its phases' spans are kept in ``STORE.spans``."""
    if _profiler._is_profiler_enabled:
        return _Recording(device)
    return _OFF


# -- graph nodes, through the CUDA driver -------------------------------------

@functools.lru_cache(maxsize=1)
def driver():
    """``libcuda`` with the signatures of the graph queries declared."""
    cu = ctypes.CDLL("libcuda.so.1")
    ptr, size_p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)
    for fn, args in (("cuGraphGetNodes", [ptr, ptr, size_p]),
                     ("cuGraphNodeGetType", [ptr, ptr]),
                     ("cuGraphKernelNodeGetParams_v2", [ptr, ptr]),
                     ("cuFuncGetName", [ptr, ptr]),
                     ("cuKernelGetName", [ptr, ptr]),
                     ("cuStreamGetCaptureInfo_v3", [ptr] * 7),
                     ("cuStreamGetCaptureInfo_v2", [ptr] * 6)):
        f = getattr(cu, fn, None)   # a driver has one of the last two
        if f is not None:
            f.argtypes, f.restype = args, ctypes.c_int
    return cu


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed with CUresult {rc}")


def node_count(graph) -> int:
    """The count of nodes ``graph`` (a ``CUgraph``) holds."""
    n = ctypes.c_size_t(0)
    check(driver().cuGraphGetNodes(graph, None, ctypes.byref(n)),
          "cuGraphGetNodes")
    return n.value


def graph_nodes(graph) -> List[Tuple[int, ctypes.c_void_p]]:
    """(type, node) of every node of ``graph``, in the graph's node order
    (the order of their capture)."""
    cu = driver()
    n = ctypes.c_size_t(node_count(graph))
    nodes = (ctypes.c_void_p * n.value)()
    check(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
          "cuGraphGetNodes")
    out = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                    ctypes.byref(kind)),
              "cuGraphNodeGetType")
        out.append((kind.value, ctypes.c_void_p(node)))
    return out


def _capturing_graph(stream: int) -> ctypes.c_void_p:
    """The ``CUgraph`` that ``stream`` captures into now."""
    cu = driver()
    status, graph = ctypes.c_int(0), ctypes.c_void_p()
    ident = ctypes.c_uint64(0)
    args = [ctypes.c_void_p(stream), ctypes.byref(status),
            ctypes.byref(ident), ctypes.byref(graph), None, None]
    if hasattr(cu, "cuStreamGetCaptureInfo_v3"):
        # the edge data's out-pointer comes before the count's
        check(cu.cuStreamGetCaptureInfo_v3(*args, None),
              "cuStreamGetCaptureInfo_v3")
    else:
        check(cu.cuStreamGetCaptureInfo_v2(*args),
              "cuStreamGetCaptureInfo_v2")
    if status.value != 1:   # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("labelling needs a stream capture under way")
    return graph


class _Labelling:
    """A labelled capture: ``marks`` holds (phase, first node, end node)
    for each phase run, in node counts of the graph under capture."""

    def __enter__(self):
        global _marks, _graph
        if _marks is not None:
            raise RuntimeError("a labelled capture is already running")
        _graph = _capturing_graph(torch.cuda.current_stream().cuda_stream)
        self.marks = _marks = []
        return self

    def __exit__(self, *exc):
        global _marks, _graph, _open
        _marks = _graph = _open = None
        return False


def labelling() -> _Labelling:
    """Inside a CUDA graph capture on the current stream: the context in
    which each phase marks the nodes captured in it."""
    return _Labelling()


def label_nodes(marks: Sequence[Tuple[str, int, int]],
                kinds: Sequence[int]) -> Tuple[str, ...]:
    """One phase for each node of ``kinds`` (node types in node order)
    that runs on the device (``DEVICE_NODE_KINDS``), in node order: the
    phase whose marked node range [first, end) holds it, else
    ``UNLABELLED``."""
    labels = [UNLABELLED] * len(kinds)
    for name, first, end in marks:
        if not 0 <= first <= end <= len(kinds):
            raise ValueError(f"phase {name!r} marks nodes {first} to {end} "
                             f"of a graph of {len(kinds)}")
        labels[first:end] = [name] * (end - first)
    return tuple(lab for lab, kind in zip(labels, kinds)
                 if kind in DEVICE_NODE_KINDS)
