"""Seeded inputs for the tests and ``chip_smoke.py``: one split step (a
level's histograms and a ``GrowState`` partway through a tree), and a
whole fit (``fit_case``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.gbt_hist.ops import GrowState

KINDS = ("random", "ties", "mcw_blocks", "zero_weights", "wide")
# The main path's whole fits, each one gbt_grow launch on the card: (L
# problems, n rows, f features, bins, max_depth, trees, distinct bin ids a
# feature for ``fit_case``, 0 for uniform ids).  Alg 3 (3 outputs), the
# registry's joint Alg 3 (38 combinations x 3 outputs, 16 database rows),
# Alg 7 (binary subset features over the chains' 125 logged subsets), and
# the vanilla XGBoost and gradient boosting baselines on inhouse's 3,360
# training rows (a grid's few input values fill a few bins).
MAIN_FITS = {"Alg 3": (3, 48, 7, 64, 4, 150, 0),
             "registry": (114, 16, 7, 64, 4, 150, 0),
             "Alg 7": (1, 125, 24, 4, 4, 200, 2),
             "vanilla XGBoost": (1, 3360, 3, 64, 6, 100, 8),
             "gradient boosting": (1, 3360, 3, 64, 3, 100, 8)}


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


def fit_case(seed: int, L: int, n: int, f: int, n_bins: int,
             distinct: int = 0, out_frac: float = 0.2) -> dict:
    """A fit of L problems as numpy arrays: bin ids ``bins`` (L, n, f),
    targets ``y`` (L, n) that depend on them, 0/1 row weights ``w`` (a
    share ``out_frac`` of rows out of the fit) and ``base`` (L,), the mean
    target of each problem's rows in the fit.  With ``distinct``, each
    feature takes that many bin ids, as a grid's few input values fill a
    few quantile bins; else ids are uniform."""
    rng = np.random.default_rng(seed)
    if distinct:
        vals = np.sort(rng.permuted(np.broadcast_to(
            np.arange(n_bins), (L, f, n_bins)), axis=-1)[..., :distinct])
        pick = rng.integers(0, distinct, (L, n, f))
        bins = np.take_along_axis(vals[:, None], pick[..., None],
                                  -1)[..., 0]
    else:
        bins = rng.integers(0, n_bins, (L, n, f))
    x = bins / n_bins
    y = (3 * x[..., 0] + np.sin(6 * x[..., -1]) + x[..., f // 2] ** 2
         + rng.normal(0, 0.1, (L, n)))
    w = (rng.random((L, n)) >= out_frac).astype(np.float64)
    base = np.array([y[l, w[l] > 0].mean() if (w[l] > 0).any() else 0.0
                     for l in range(L)])
    return dict(bins=bins.astype(np.int32), y=y, w=w, base=base)


def fit_state(case: dict, n_trees: int, max_depth: int,
              device) -> GrowState:
    """``case``'s fit before its first tree, on ``device``."""
    return GrowState.start(case["bins"], case["y"], case["w"], case["base"],
                           n_trees, max_depth, device)
