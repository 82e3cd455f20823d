"""Seeded inputs of one split step, for the tests and ``chip_smoke.py``:
a level's histograms and a ``GrowState`` partway through a tree."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gbt_hist.ops import GrowState

KINDS = ("random", "ties", "mcw_blocks", "zero_weights", "wide")


def level_case(seed: int, L: int, width: int, f: int, n_bins: int,
               kind: str = "random", n: int = 60) -> dict:
    """One level of ``width`` nodes as numpy arrays: histograms ``hist``
    (L, width, f, n_bins, 2) float32, each feature's bins a permutation of
    one set (so every feature sums to the node's totals, as a level's do),
    and ``n`` rows a problem on its valid nodes.  ``kind``:

    * ``ties``: 60% of the bins empty, so runs of candidates share a gain;
    * ``mcw_blocks``: ``min_child_weight`` 1e30, which blocks every split;
    * ``zero_weights``: the last problem has no row in the fit and empty
      histograms;
    * ``wide``: exponents spread over some 2**60, where numpy's pairwise
      sum and a sequential one differ."""
    if kind not in KINDS:
        raise ValueError(f"kind {kind!r} not in {KINDS}")
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, width + 1, L)
    n_valid[0] = width
    g = rng.standard_normal((L, width, 1, n_bins))
    h = rng.integers(0, 6, (L, width, 1, n_bins)).astype(np.float64)
    if kind == "ties":
        empty = rng.random(g.shape) < 0.6
        g[empty] = 0.0
        h[empty] = 0.0
    elif kind == "wide":
        g *= np.exp2(rng.uniform(-30, 30, g.shape))
        h = rng.random(h.shape) * np.exp2(rng.uniform(-30, 30, h.shape))
    perm = rng.permuted(np.broadcast_to(np.arange(n_bins),
                                        (L, width, f, n_bins)), axis=-1)
    perm[:, :, 0] = np.arange(n_bins)
    hist = np.ascontiguousarray(np.stack(
        [np.take_along_axis(np.broadcast_to(a, perm.shape), perm, -1)
         for a in (g, h)], -1), np.float32)
    in_fit = rng.random((L, n)) < 0.8
    if kind == "zero_weights":
        hist[-1] = 0.0
        in_fit[-1] = False
    return dict(
        hist=hist, bins=rng.integers(0, n_bins, (L, n, f)).astype(np.int32),
        node=(rng.random((L, n)) * n_valid[:, None]).astype(np.int64),
        in_fit=in_fit, pred=rng.standard_normal((L, n)),
        y=rng.standard_normal((L, n)), n_valid=n_valid,
        first=rng.integers(0, width, L),   # node ids stay below 4 * width
        mcw=1e30 if kind == "mcw_blocks" else 1.0)


def level_state(case: dict, n_trees: int, max_depth: int,
                device) -> GrowState:
    """A ``GrowState`` on ``device`` at ``case``'s level: rows in the fit
    on their nodes (the others at -1), its predictions and targets."""
    w = case["in_fit"].astype(np.float64)
    L, n = w.shape
    s = GrowState.start(case["bins"], case["y"], w, np.zeros(L), n_trees,
                        max_depth, device)
    s.pred.copy_(torch.from_numpy(case["pred"]))
    s.node.copy_(torch.from_numpy(
        np.where(case["in_fit"], case["node"], -1).astype(np.int32)))
    s.level.copy_(torch.from_numpy(
        np.stack([case["first"], case["n_valid"]], 1).astype(np.int32)))
    return s
