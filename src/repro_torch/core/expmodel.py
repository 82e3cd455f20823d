"""Generalized exponential throughput model (paper Alg 1).

    thpt(bb) = c - a * exp(-b * bb)

a: initial-improvement magnitude; b: saturation rate; c: saturation
throughput (asymptote).
"""
from __future__ import annotations

import numpy as np


def exp_model(bb, a, b, c):
    """Vectorized Alg 1 in float64 (host bookkeeping; the device solves
    the fit itself, ``core/fit.py``)."""
    return c - a * np.exp(-b * np.asarray(bb, dtype=np.float64))


def initial_params(bb: np.ndarray, thpt: np.ndarray):
    """Percentile-based initialization (paper Alg 2, lines 6-14)."""
    if len(np.unique(bb)) > 1:
        t10, t90 = np.percentile(thpt, [10, 90])
        b10, b90 = np.percentile(bb, [10, 90])
        b90 = max(b90, b10 + 1e-3)
        a0 = max(t90 - t10, 1e-5)
        b0 = 1.0 / max(b90 - b10, 1e-5)
        c0 = max(t90, 1e-5)
    else:
        a0, b0, c0 = 1.0, 0.001, 0.0
    return np.array([a0, b0, c0], np.float64)
