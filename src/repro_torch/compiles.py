"""The port's process-global count of compilations, by kind.

A compilation is a CUDA graph capture (``inference/engine.py``) or an
``nvcc`` build of a CUDA source (``kernels/_build.py``); each such site
calls :func:`note_compile`.  ``staticcheck.tracers.assert_max_compiles``
diffs these counts around a block.  The module imports nothing, so the
runtime layers that count do not load the tooling that reads the count.
"""
from typing import Dict

# compilations counted since the process started, by kind
COUNTS: Dict[str, int] = {"capture": 0, "build": 0}


def note_compile(kind: str) -> None:
    """Counts one compilation of ``kind`` ("capture" or "build")."""
    if kind not in COUNTS:
        raise ValueError(f"unknown compile kind {kind!r}; expected one of "
                         f"{sorted(COUNTS)}")
    COUNTS[kind] += 1
