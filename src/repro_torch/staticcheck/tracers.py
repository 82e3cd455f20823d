"""Runtime tracers for the contracts static analysis can't see.

``jit-in-loop`` catches the *syntactic* compile hazard; whether the
port's compile-once placement actually holds at runtime (a decode graph
captured once a signature, every kernel built once, nothing compiled in a
steady-state loop) is only observable by counting compilations.
:func:`assert_max_compiles` is that gate: a context manager that counts
the port's compilations inside its block and raises past a budget.  In the
port a compilation is one of:

  * a CUDA graph capture (``inference/engine.py::DecodeGraph._capture``),
  * an ``nvcc`` build of a CUDA source (``kernels/_build.py::build``; a
    cached library is not a build),
  * a ``torch.compile`` frame (Dynamo's ``counters["frames"]["ok"]``).

Eager torch compiles nothing else.  The capture and build sites call
``repro_torch.compiles.note_compile``, which bumps a process-global
counter; each block diffs the counters around itself.  Dynamo's frame count is read only if
``torch._dynamo`` is already imported: if it never was, no frame was
compiled, and importing it costs seconds (and can pull in ``triton``).

:func:`nan_guard` is the second runtime tracer: fit/predict outputs must
never carry NaN (Alg 7/8 would silently propagate it into confidence
scores); +/-inf stays allowed by default because the degenerate-log
sentinel (d_min=inf, confidence=0.0) is a documented output.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import sys
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch.compiles import COUNTS, note_compile

__all__ = [
    "CompileReport", "CompileBudgetExceeded", "assert_max_compiles",
    "count_compiles", "nan_guard", "note_compile",
]

def _frames() -> int:
    """Frames ``torch.compile`` has compiled in this process (0 unless
    ``torch._dynamo`` is imported)."""
    utils = sys.modules.get("torch._dynamo.utils")
    return 0 if utils is None else int(utils.counters["frames"]["ok"])


class CompileBudgetExceeded(AssertionError):
    """Raised when a block compiles more than budgeted."""


@dataclasses.dataclass
class CompileReport:
    """What compiled inside an ``assert_max_compiles`` block."""
    limit: Optional[int] = None
    label: str = ""
    n_captures: int = 0            # CUDA graph captures
    n_builds: int = 0              # nvcc builds
    n_frames: int = 0              # torch.compile frames

    @property
    def count(self) -> int:
        """The compilations the gate counts: all three kinds."""
        return self.n_captures + self.n_builds + self.n_frames


@contextlib.contextmanager
def assert_max_compiles(n: Optional[int],
                        label: str = "") -> Iterator[CompileReport]:
    """Gate a block to at most ``n`` compilations.

    Yields a :class:`CompileReport` that fills in on exit; raises
    :class:`CompileBudgetExceeded` when the block captured, built or
    compiled more than ``n`` times.  ``n=None`` counts without asserting.
    """
    report = CompileReport(limit=n, label=label)
    c0, b0, f0 = COUNTS["capture"], COUNTS["build"], _frames()
    try:
        yield report
    finally:
        report.n_captures = COUNTS["capture"] - c0
        report.n_builds = COUNTS["build"] - b0
        report.n_frames = _frames() - f0
    if n is not None and report.count > n:
        where = f" [{label}]" if label else ""
        raise CompileBudgetExceeded(
            f"compile budget exceeded{where}: {report.count} > {n} "
            f"(captures={report.n_captures}, builds={report.n_builds}, "
            f"frames={report.n_frames}) — a signature the warmup didn't "
            f"cover, or a graph captured, kernel built or function "
            f"compiled inside the hot path")


def count_compiles(label: str = ""):
    """``assert_max_compiles(None)``: count without asserting."""
    return assert_max_compiles(None, label=label)


def _first_bad_leaf(obj, path: str, allow_inf: bool):
    """Depth-first search for a NaN (or inf) leaf; returns its path."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            bad = _first_bad_leaf(v, f"{path}[{k!r}]", allow_inf)
            if bad:
                return bad
        return None
    if isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            bad = _first_bad_leaf(v, f"{path}[{i}]", allow_inf)
            if bad:
                return bad
        return None
    if isinstance(obj, torch.Tensor):
        # to the host, and bf16/fp16 widened: numpy holds neither
        obj = obj.detach().cpu()
        if obj.is_floating_point() and obj.element_size() < 4:
            obj = obj.float()
        obj = obj.numpy()
    try:
        arr = np.asarray(obj)
    except Exception:
        return None
    if arr.dtype.kind not in "fc":
        return None
    if np.isnan(arr).any():
        return f"{path}: NaN"
    if not allow_inf and np.isinf(arr).any():
        return f"{path}: inf"
    return None


def nan_guard(fn=None, *, label: Optional[str] = None,
              allow_inf: bool = True):
    """Wrap a fit/predict callable so non-finite outputs raise loudly.

    ``FloatingPointError`` names the function and the offending output
    leaf (numpy arrays, scalars and torch tensors on any device, nested in
    dicts, lists and tuples).  ``allow_inf=True`` by default: the Alg 8
    degenerate-log sentinel legitimately returns (d_min=inf,
    confidence=0.0); NaN is never legitimate.  Usable bare
    (``@nan_guard``), with options (``@nan_guard(allow_inf=False)``), or
    inline (``nan_guard(eng.predict, label="online.predict")(rows)``).
    """
    def deco(f):
        name = label or getattr(f, "__qualname__", repr(f))

        @functools.wraps(f)
        def wrapped(*args, **kwargs):
            out = f(*args, **kwargs)
            bad = _first_bad_leaf(out, "output", allow_inf)
            if bad:
                raise FloatingPointError(
                    f"nan_guard[{name}]: non-finite fit output at "
                    f"{bad}")
            return out

        return wrapped

    return deco(fn) if fn is not None else deco
