"""Histogram gradient-boosted trees, from scratch (XGBoost stand-in).

Second-order boosting in the XGBoost sense [Chen & Guestrin, KDD'16]:
quantile-binned features, per-node gradient/hessian histograms, gain
  0.5 * (GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l))
shrinkage, row subsampling, and hessian-weighted leaves.  Level-wise
growth, fully vectorized over nodes.  ``use_kernel`` chooses K4
(``kernels/gbt_hist``; ``None``: K4 exactly when the model's ``device`` is
CUDA).  On the GPU, ``grow_forests`` grows every tree on the card: a fit
whose state fits a thread-block cluster's shared memory (every fit of the
ALA's path) is one launch of K4's ``gbt_grow`` for all its trees and
problems; a larger one takes two launches a level, K4's histograms for
every node of every problem and its split step (split search, leaf
values, tree entries, rows to their children, the boosting update).
Either way nothing comes back to the host until the fit ends.  Elsewhere
the host loop builds each
level's histograms with ``_joint_histograms`` (K4's plain fp32 version, or
the reference's float64 scatter-add) and searches the splits in float64
numpy; with K4 it grows the same trees bit for bit as ``grow_forests``.

Two training paths produce identical trees:

  * ``GBTRegressor.fit`` — the original single-model path (supports
    row/column subsampling).
  * ``fit_packed_forest`` — a *batched* trainer that grows the forests
    of many (candidate, output) problems in lockstep, vectorizing the
    histogram/gain/split math across all of them.  Excluded rows carry
    zero gradient/hessian weight, which leaves every sum bitwise
    unchanged, so the trees match the per-model path exactly.

Fitted trees flatten into ``PackedForest`` arrays and predict through a
gather traversal on the device (``backend="torch"``) — the inference path
the batched annealing engine uses.

This is the learning component of ALA (paper Alg 3/7) and of the RF/GB
baselines (Fig 7).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.gbt_hist import ops as gh_ops


@dataclasses.dataclass
class _Tree:
    feature: np.ndarray      # (n_nodes,) int32, -1 for leaf
    threshold: np.ndarray    # (n_nodes,) int32 bin id: go left if bin <= thr
    left: np.ndarray         # (n_nodes,) int32
    right: np.ndarray        # (n_nodes,) int32
    value: np.ndarray        # (n_nodes,) float32 leaf values

    def predict_bins(self, bins: np.ndarray) -> np.ndarray:
        node = np.zeros(bins.shape[0], dtype=np.int32)
        active = self.feature[node] >= 0
        while active.any():
            f = self.feature[node[active]]
            thr = self.threshold[node[active]]
            go_left = bins[active, f] <= thr
            nxt = np.where(go_left, self.left[node[active]],
                           self.right[node[active]])
            node[active] = nxt
            active = self.feature[node] >= 0
        return self.value[node]


class GBTRegressor:
    """Squared-error histogram GBT (see module docstring)."""

    def __init__(self, n_estimators: int = 200, learning_rate: float = 0.1,
                 max_depth: int = 4, n_bins: int = 64,
                 min_child_weight: float = 1.0, reg_lambda: float = 1.0,
                 subsample: float = 1.0, colsample: float = 1.0,
                 seed: int = 0, use_kernel: Optional[bool] = None,
                 device=None):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.n_bins = n_bins
        self.min_child_weight = min_child_weight
        self.reg_lambda = reg_lambda
        self.subsample = subsample
        self.colsample = colsample
        self.seed = seed
        self.device = resolve_device(device)
        self.use_kernel = use_kernel
        self.trees_: List[_Tree] = []
        self.base_: float = 0.0
        self.bin_edges_: Optional[np.ndarray] = None

    # -- binning -------------------------------------------------------------
    def _fit_bins(self, X: np.ndarray) -> np.ndarray:
        n, f = X.shape
        qs = np.linspace(0, 1, self.n_bins + 1)[1:-1]
        edges = np.quantile(X, qs, axis=0).T        # (f, n_bins-1)
        # dedupe per-feature edges to keep monotonicity
        self.bin_edges_ = edges
        return self._transform_bins(X)

    def _transform_bins(self, X: np.ndarray) -> np.ndarray:
        bins = np.empty(X.shape, dtype=np.int32)
        for j in range(X.shape[1]):
            bins[:, j] = np.searchsorted(self.bin_edges_[j], X[:, j],
                                         side="right")
        return bins

    # -- histogram -----------------------------------------------------------
    def _histograms(self, bins, grad, hess, node_id, n_nodes):
        """(n_nodes, f, n_bins, 2) gradient/hessian histograms."""
        hg, hh = _joint_histograms(
            bins[None], grad[None], hess[None], node_id[None], n_nodes,
            self.n_bins, _kernel_on(self.use_kernel, self.device),
            self.device)
        return np.stack([hg[0], hh[0]], axis=-1)

    # -- single tree ----------------------------------------------------------
    def _grow_tree(self, bins, grad, hess, rng) -> _Tree:
        n, f = bins.shape
        feat_mask = np.ones(f, bool)
        if self.colsample < 1.0:
            k = max(1, int(round(self.colsample * f)))
            feat_mask[:] = False
            feat_mask[rng.choice(f, size=k, replace=False)] = True

        max_nodes = 2 ** (self.max_depth + 1) - 1
        feature = np.full(max_nodes, -1, np.int32)
        threshold = np.zeros(max_nodes, np.int32)
        left = np.zeros(max_nodes, np.int32)
        right = np.zeros(max_nodes, np.int32)
        value = np.zeros(max_nodes, np.float32)
        node_of_row = np.zeros(n, np.int32)   # index into current level list
        # current level: list of node ids; rows hold level-local index
        level_nodes = [0]
        next_free = 1
        lam = self.reg_lambda

        for depth in range(self.max_depth + 1):
            n_level = len(level_nodes)
            if n_level == 0:
                break
            hist = self._histograms(bins, grad, hess, node_of_row, n_level)
            G = hist[..., 0].sum(axis=2)      # (n_level, f) totals per feat
            H = hist[..., 1].sum(axis=2)
            Gtot, Htot = G[:, 0], H[:, 0]
            leaf_val = -Gtot / (Htot + lam)

            if depth == self.max_depth:
                for li, nid in enumerate(level_nodes):
                    value[nid] = leaf_val[li]
                break

            GL = np.cumsum(hist[..., 0], axis=2)   # (n_level, f, n_bins)
            HL = np.cumsum(hist[..., 1], axis=2)
            GR = Gtot[:, None, None] - GL
            HR = Htot[:, None, None] - HL
            gain = 0.5 * (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                          - (Gtot ** 2 / (Htot + lam))[:, None, None])
            ok = (HL >= self.min_child_weight) & (HR >= self.min_child_weight)
            ok &= feat_mask[None, :, None]
            ok[..., -1] = False                     # right side must be non-empty
            gain = np.where(ok, gain, -np.inf)
            flat = gain.reshape(n_level, -1)
            best = flat.argmax(axis=1)
            best_gain = flat[np.arange(n_level), best]
            best_f = (best // self.n_bins).astype(np.int32)
            best_b = (best % self.n_bins).astype(np.int32)

            new_level = []
            remap = np.full(n_level, -1, np.int32)  # level idx -> keeps rows
            child_base = {}
            for li, nid in enumerate(level_nodes):
                if not np.isfinite(best_gain[li]) or best_gain[li] <= 1e-12:
                    value[nid] = leaf_val[li]
                    continue
                feature[nid] = best_f[li]
                threshold[nid] = best_b[li]
                left[nid] = next_free
                right[nid] = next_free + 1
                child_base[li] = len(new_level)
                new_level.extend([next_free, next_free + 1])
                next_free += 2

            if not new_level:
                break
            # reassign rows to level-local indices of the next level
            new_node_of_row = np.full(len(node_of_row), -1, np.int32)
            for li in child_base:
                rows = node_of_row == li
                go_left = bins[rows, best_f[li]] <= best_b[li]
                new_node_of_row[rows] = child_base[li] + (~go_left)
            keep = new_node_of_row >= 0
            bins, grad, hess = bins[keep], grad[keep], hess[keep]
            node_of_row = new_node_of_row[keep]
            level_nodes = new_level

        return _Tree(feature=feature[:next_free],
                     threshold=threshold[:next_free],
                     left=left[:next_free], right=right[:next_free],
                     value=value[:next_free])

    # -- public API -------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBTRegressor":
        X = np.asarray(X, np.float64)
        y = np.asarray(y, np.float64)
        assert X.ndim == 2 and y.shape == (X.shape[0],)
        rng = np.random.default_rng(self.seed)
        bins = self._fit_bins(X)
        self.base_ = float(y.mean()) if len(y) else 0.0
        self._packed = None
        if (self.subsample >= 1.0 and self.colsample >= 1.0
                and _resident_on(self.use_kernel, self.device, self.n_bins,
                                 self.max_depth)):
            F, TH, LE, RI, V, NN = grow_forests(
                bins[None], y[None], np.ones((1, len(y))),
                np.array([self.base_]), self.n_estimators,
                self.learning_rate, self.max_depth, self.n_bins,
                self.min_child_weight, self.reg_lambda, self.device)
            self.trees_ = [_Tree(feature=F[0, t, :nn], threshold=TH[0, t, :nn],
                                 left=LE[0, t, :nn], right=RI[0, t, :nn],
                                 value=V[0, t, :nn])
                           for t, nn in enumerate(NN[0])]
            return self
        pred = np.full_like(y, self.base_)
        self.trees_ = []
        for t in range(self.n_estimators):
            grad = pred - y
            hess = np.ones_like(y)
            if self.subsample < 1.0:
                take = rng.random(len(y)) < self.subsample
                if take.sum() < 2:
                    take[:] = True
            else:
                take = slice(None)
            tree = self._grow_tree(bins[take], grad[take], hess[take], rng)
            self.trees_.append(tree)
            pred += self.learning_rate * tree.predict_bins(bins)
        return self

    def predict(self, X: np.ndarray, backend: str = "numpy") -> np.ndarray:
        """Predict; ``backend="torch"`` flattens the forest once and runs
        the gather traversal on the model's device (``PackedForest``)."""
        X = np.asarray(X, np.float64)
        if backend == "torch":
            packed = getattr(self, "_packed", None)
            if packed is None:
                packed = self._packed = pack_models([[self]])
            return packed.predict(X[None], backend="torch")[0, :, 0]
        bins = self._transform_bins(X)
        out = np.full(X.shape[0], self.base_, np.float64)
        for tree in self.trees_:
            out += self.learning_rate * tree.predict_bins(bins)
        return out


class MultiOutputGBT:
    """One GBTRegressor per target column (paper: MultiOutputRegressor).

    When no row/column subsampling is configured, ``fit`` grows all
    output forests jointly through ``fit_packed_forest`` (identical
    trees, one pass of vectorized level-wise growth instead of
    ``n_outputs`` sequential fits).
    """

    def __init__(self, n_outputs: int, **kw):
        seed = kw.pop("seed", 0)
        self.models = [GBTRegressor(seed=seed + i, **kw)
                       for i in range(n_outputs)]

    @property
    def can_joint(self) -> bool:
        """Whether ``fit_joint`` grows these forests in one joint fit: no
        row or column sampling (it draws per model), and at least one
        output."""
        return bool(self.models) and all(
            m.subsample >= 1.0 and m.colsample >= 1.0 for m in self.models)

    def fit(self, X, Y, joint: Optional[bool] = None):
        Y = np.asarray(Y)
        if joint is False:
            self._fit_each(X, Y)
            return self
        self.fit_joint(np.asarray(X, np.float64)[None], Y[None])
        return self

    def _fit_each(self, X, Y) -> None:
        for i, m in enumerate(self.models):
            m.fit(X, Y[:, i])

    def fit_joint(self, X, Y, W=None, into=None) -> List["MultiOutputGBT"]:
        """Fits C problems at this model's settings, problem c into
        ``into[c]`` (default: this model alone, C = 1), and returns
        ``into``: X (C, n, f), Y (C, n, O), W (C, n) row weights (padding
        rows 0).  Where ``can_joint`` holds, all grow in one
        ``fit_packed_forest`` call; else each model fits its problem's rows
        of weight > 0 one output at a time, as ``fit`` would."""
        into = [self] if into is None else into
        if not self.can_joint:
            for c, m in enumerate(into):
                keep = slice(None) if W is None else np.asarray(W[c]) > 0
                m._fit_each(np.asarray(X[c])[keep], np.asarray(Y[c])[keep])
            return into
        m0 = self.models[0]
        forest = fit_packed_forest(
            X, Y, W, n_estimators=m0.n_estimators,
            learning_rate=m0.learning_rate, max_depth=m0.max_depth,
            n_bins=m0.n_bins, min_child_weight=m0.min_child_weight,
            reg_lambda=m0.reg_lambda, use_kernel=m0.use_kernel,
            device=m0.device)
        for c, m in enumerate(into):
            m.take(forest, c)
        return into

    def take(self, forest: "PackedForest", c: int) -> "MultiOutputGBT":
        """Adopt problem ``c``'s forests of a joint fit as this model's."""
        for o, m in enumerate(self.models):
            m.base_ = float(forest.base[c, o])
            m.bin_edges_ = forest.bin_edges[c].copy()
            m.trees_ = [
                _Tree(feature=forest.feature[c, o, t, :nn].copy(),
                      threshold=forest.threshold[c, o, t, :nn].copy(),
                      left=forest.left[c, o, t, :nn].copy(),
                      right=forest.right[c, o, t, :nn].copy(),
                      value=forest.value[c, o, t, :nn].copy())
                for t, nn in enumerate(forest.n_nodes[c, o])]
            m._packed = None
        return self

    def predict(self, X):
        return np.stack([m.predict(X) for m in self.models], axis=1)


class RandomForestRegressor:
    """Bagged depth-unlimited-ish trees (baseline #3 in Fig 7)."""

    def __init__(self, n_estimators: int = 100, max_depth: int = 8,
                 n_bins: int = 64, subsample: float = 0.8,
                 colsample: float = 0.8, seed: int = 0, device=None):
        self.kw = dict(n_estimators=1, learning_rate=1.0,
                       max_depth=max_depth, n_bins=n_bins,
                       min_child_weight=1.0, reg_lambda=1e-6,
                       device=resolve_device(device))
        self.n_estimators = n_estimators
        self.subsample = subsample
        self.colsample = colsample
        self.seed = seed
        self.members_: List[GBTRegressor] = []

    def fit(self, X, y):
        rng = np.random.default_rng(self.seed)
        n = len(y)
        self.members_ = []
        for i in range(self.n_estimators):
            idx = rng.integers(0, n, size=n)      # bootstrap
            m = GBTRegressor(seed=self.seed + i, subsample=1.0,
                             colsample=self.colsample, **self.kw)
            m.fit(X[idx], y[idx])
            self.members_.append(m)
        return self

    def predict(self, X):
        return np.mean([m.predict(X) for m in self.members_], axis=0)


# ---------------------------------------------------------------------------
# Packed forests: flattened tree arrays + batched training and inference
# ---------------------------------------------------------------------------

def _kernel_on(use_kernel: Optional[bool], device: torch.device) -> bool:
    """``use_kernel=None`` means K4 exactly when the device is CUDA."""
    return device.type == "cuda" if use_kernel is None else bool(use_kernel)


def _resident_on(use_kernel: Optional[bool], device: torch.device,
                 n_bins: int, max_depth: int) -> bool:
    """Whether a fit grows its trees on the card (``grow_forests``): K4 on
    a CUDA device, within the split step's limits."""
    return (_kernel_on(use_kernel, device) and device.type == "cuda"
            and n_bins <= gh_ops.SPLIT_MAX_BINS
            and max_depth <= gh_ops.SPLIT_MAX_DEPTH)


def kernel_histograms(bins, grad, hess, node_id, n_nodes, n_bins,
                      device=None):
    """Per-node histograms of one problem through K4: (n, f) bins + (n,)
    grad/hess/node ids -> (n_nodes, f, n_bins, 2) float64.

    On a CUDA ``device`` the kernel sums in fp32, in row order; on the
    CPU its plain version does the same sums."""
    hg, hh = _joint_histograms(bins[None], grad[None], hess[None],
                               np.asarray(node_id)[None], n_nodes, n_bins,
                               True, resolve_device(device))
    return np.stack([hg[0], hh[0]], axis=-1)


@dataclasses.dataclass
class PackedForest:
    """Fitted GBT forests flattened to arrays, batched over a grid of
    ``(C candidates, O outputs)`` independent models.

    ``feature[c, o, t, n] < 0`` marks node ``n`` of tree ``t`` as a leaf;
    internal nodes route rows left when ``bin <= threshold``.  This is
    the batched inference form: prediction is a fixed-depth gather
    traversal over every tree, output and candidate at once, on
    ``device``.
    """
    feature: np.ndarray     # (C, O, T, N) int32, -1 for leaf
    threshold: np.ndarray   # (C, O, T, N) int32 bin ids
    left: np.ndarray        # (C, O, T, N) int32
    right: np.ndarray       # (C, O, T, N) int32
    value: np.ndarray       # (C, O, T, N) float32 leaf values
    base: np.ndarray        # (C, O) float64
    bin_edges: np.ndarray   # (C, f, n_bins - 1) float64
    n_nodes: np.ndarray     # (C, O, T) int32 used-node counts
    learning_rate: float
    max_depth: int
    device: str = "cpu"

    def transform_bins(self, X: np.ndarray) -> np.ndarray:
        """X: (C, m, f) raw features -> (C, m, f) int32 bin ids."""
        C, m, f = X.shape
        bins = np.empty((C, m, f), np.int32)
        for c in range(C):
            for j in range(f):
                bins[c, :, j] = np.searchsorted(self.bin_edges[c, j],
                                                X[c, :, j], side="right")
        return bins

    def predict(self, X: np.ndarray, backend: str = "torch") -> np.ndarray:
        """X: (C, m, f) -> (C, m, O) predictions.

        ``backend="torch"`` finds the leaves on ``device``
        (``_apply_torch``); ``"numpy"`` on the host.  Both sum the leaf
        values over trees in float64 numpy, so they agree bit for bit."""
        bins = self.transform_bins(np.asarray(X, np.float64))
        if backend == "torch":
            leaf = self._apply_torch(bins)
        else:
            leaf = self._apply_numpy(bins)
        out = self.base[:, :, None] + self.learning_rate * leaf.sum(axis=2)
        return np.moveaxis(out, 1, 2)        # (C, m, O)

    def _apply_numpy(self, bins: np.ndarray) -> np.ndarray:
        """(C, O, T, m) leaf values via vectorized numpy traversal."""
        C, O, T, N = self.feature.shape
        m = bins.shape[1]
        out = np.empty((C, O, T, m), np.float64)
        for c in range(C):
            rows = bins[c]                                # (m, f)
            for o in range(O):
                nd = np.zeros((T, m), np.int64)
                ft = self.feature[c, o].astype(np.int64)  # (T, N)
                th = self.threshold[c, o]
                lf = self.left[c, o].astype(np.int64)
                rt = self.right[c, o].astype(np.int64)
                for _ in range(self.max_depth + 1):
                    f_ = np.take_along_axis(ft, nd, 1)
                    isleaf = f_ < 0
                    rb = rows[np.arange(m)[None, :], np.maximum(f_, 0)]
                    go_left = rb <= np.take_along_axis(th, nd, 1)
                    nxt = np.where(go_left, np.take_along_axis(lf, nd, 1),
                                   np.take_along_axis(rt, nd, 1))
                    nd = np.where(isleaf, nd, nxt)
                out[c, o] = np.take_along_axis(
                    self.value[c, o].astype(np.float64), nd, 1)
        return out

    def _apply_torch(self, bins: np.ndarray) -> np.ndarray:
        """(C, O, T, m) leaf values: ``max_depth + 1`` gather steps over
        every (candidate, output, tree, row) at once on ``device``
        (leaves are absorbing), then the float32 leaf values to the host."""
        dev = torch.device(self.device)
        C, O, T, N = self.feature.shape
        m, f = bins.shape[1:]

        def put(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        ft, th, lf, rt = (put(a).long() for a in (
            self.feature, self.threshold, self.left, self.right))
        rows = put(bins)[:, None, None].expand(C, O, T, m, f)
        nd = torch.zeros((C, O, T, m), dtype=torch.int64, device=dev)
        for _ in range(self.max_depth + 1):
            f_ = torch.gather(ft, 3, nd)
            rb = torch.gather(rows, 4, f_.clamp(min=0)[..., None])[..., 0]
            nxt = torch.where(rb <= torch.gather(th, 3, nd),
                              torch.gather(lf, 3, nd), torch.gather(rt, 3, nd))
            nd = torch.where(f_ < 0, nd, nxt)
        leaf = torch.gather(put(self.value), 3, nd)
        return leaf.cpu().numpy().astype(np.float64)


def pack_models(models: List[List[GBTRegressor]]) -> PackedForest:
    """Flatten a (C, O) grid of fitted GBTRegressors into a PackedForest."""
    C, O = len(models), len(models[0])
    T = max(len(m.trees_) for row in models for m in row)
    N = max([1] + [len(t.feature) for row in models for m in row
                   for t in m.trees_])
    m0 = models[0][0]
    shape = (C, O, T, N)
    feature = np.full(shape, -1, np.int32)
    threshold = np.zeros(shape, np.int32)
    left = np.zeros(shape, np.int32)
    right = np.zeros(shape, np.int32)
    value = np.zeros(shape, np.float32)
    n_nodes = np.ones((C, O, T), np.int32)
    base = np.zeros((C, O), np.float64)
    edges = np.stack([row[0].bin_edges_ for row in models])
    for c, row in enumerate(models):
        for o, m in enumerate(row):
            base[c, o] = m.base_
            for t, tree in enumerate(m.trees_):
                nn = len(tree.feature)
                n_nodes[c, o, t] = nn
                feature[c, o, t, :nn] = tree.feature
                threshold[c, o, t, :nn] = tree.threshold
                left[c, o, t, :nn] = tree.left
                right[c, o, t, :nn] = tree.right
                value[c, o, t, :nn] = tree.value
    return PackedForest(feature=feature, threshold=threshold, left=left,
                        right=right, value=value, base=base,
                        bin_edges=edges, n_nodes=n_nodes,
                        learning_rate=m0.learning_rate,
                        max_depth=m0.max_depth, device=str(m0.device))


def _joint_histograms(bins, grad, hess, node, nlvl, n_bins, use_kernel,
                      device):
    """(L, n, f) bins + (L, n) grad/hess + (L, n) level-local node ids ->
    (L, nlvl, f, n_bins) float64 gradient and hessian histograms of one
    tree level.

    ``use_kernel``: one K4 call for all L problems on ``device`` (fp32
    sums in row order, returned as float64); otherwise the reference's
    float64 host scatter-add (bincount, also in row order).
    ``_joint_histograms.levels`` counts the levels built either way."""
    _joint_histograms.levels += 1
    L, n, f = bins.shape
    if use_kernel:
        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        h = gh_ops.build_node_histograms(
            put(bins, np.int32), put(grad, np.float32),
            put(hess, np.float32), put(node, np.int32), nlvl, n_bins)
        h = h.cpu().numpy().astype(np.float64)
        return h[..., 0], h[..., 1]
    size = L * nlvl * f * n_bins
    l_off = (np.arange(L, dtype=np.int64)
             * (nlvl * f * n_bins))[:, None, None]
    flat = ((node[:, :, None].astype(np.int64) * f
             + np.arange(f, dtype=np.int64)) * n_bins + bins + l_off)
    flat = flat.ravel()
    gw = np.broadcast_to(grad[:, :, None], (L, n, f)).ravel()
    hw = np.broadcast_to(hess[:, :, None], (L, n, f)).ravel()
    hist_g = np.bincount(flat, gw, minlength=size) \
        .reshape(L, nlvl, f, n_bins)
    hist_h = np.bincount(flat, hw, minlength=size) \
        .reshape(L, nlvl, f, n_bins)
    return hist_g, hist_h


_joint_histograms.levels = 0


def grow_forests(bins, y, w, base, n_estimators: int, learning_rate: float,
                 max_depth: int, n_bins: int, min_child_weight: float,
                 reg_lambda: float, device):
    """Grows T = ``n_estimators`` trees for each of L problems on
    ``device``: bins (L, n, f) int32 bin ids, y (L, n) targets, w (L, n)
    row weights (a row is in the fit where w > 0), base (L,) starting
    predictions.  Returns numpy (F, TH, LE, RI, V, NN): (L, T, N) feature,
    threshold, left, right and value arrays and (L, T) node counts, N =
    2**(max_depth + 1) - 1, as ``_grow_forests_host`` with K4 grows them,
    bit for bit.

    The inputs go to the device once.  A fit that ``gh_ops.fits_on_chip``
    accepts is one ``grow_fit`` (all its trees in one launch on the card);
    any other grows level by level (``_grow_levels``).  Nothing comes back
    and nothing synchronises until the trees come back at the end.
    ``grow_forests.levels`` counts the tree levels grown either way,
    ``grow_forests.fits`` the fits."""
    device = resolve_device(device)
    L, n, f = bins.shape
    s = gh_ops.GrowState.start(bins, y, w, base, n_estimators, max_depth,
                               device)
    grow_forests.fits += 1
    if gh_ops.fits_on_chip(L, n, f, n_bins, max_depth):
        gh_ops.grow_fit(s, n_estimators, max_depth, n_bins, reg_lambda,
                        min_child_weight, learning_rate)
        grow_forests.levels += n_estimators * (max_depth + 1)
    else:
        _grow_levels(s, n_estimators, max_depth, n_bins, reg_lambda,
                     min_child_weight, learning_rate)
    trees = torch.stack([s.feature, s.threshold, s.left, s.right])
    return (*trees.cpu().numpy(), s.value.cpu().numpy(),
            s.n_nodes.cpu().numpy())


grow_forests.levels = 0
grow_forests.fits = 0


def _grow_levels(s, n_estimators, max_depth, n_bins, reg_lambda,
                 min_child_weight, learning_rate) -> None:
    """``grow_forests`` level by level: every tree level is one
    ``build_node_histograms`` and one ``split_level`` over all L problems
    of the state ``s``, at the level's full width 2**depth (nodes past a
    problem's valid ones hold no rows)."""
    L, n, f = s.bins.shape
    hists = [torch.empty((L, 2 ** d, f, n_bins, 2), dtype=torch.float32,
                         device=s.bins.device) for d in range(max_depth + 1)]
    for t in range(n_estimators):
        for depth, hist in enumerate(hists):
            gh_ops.build_node_histograms(s.bins, s.grad, s.hess, s.node,
                                         2 ** depth, n_bins, out=hist)
            gh_ops.split_level(hist, s, t, depth, max_depth, reg_lambda,
                               min_child_weight, learning_rate)
            grow_forests.levels += 1


def fit_packed_forest(X, Y, W=None, n_estimators: int = 100,
                      learning_rate: float = 0.1, max_depth: int = 4,
                      n_bins: int = 64, min_child_weight: float = 1.0,
                      reg_lambda: float = 1.0,
                      use_kernel: Optional[bool] = None,
                      device=None) -> PackedForest:
    """Grow GBT forests for a batch of problems in one vectorized pass.

    X: (C, n, f) features, Y: (C, n, O) targets, W: (C, n) 0/1 row
    weights (None = all rows).  All C x O forests grow level-by-level in
    lockstep; rows excluded by W (or parked at a finished leaf) keep
    zero gradient/hessian so every histogram sum matches the per-model
    ``GBTRegressor.fit`` bitwise.  ``device`` (None: the GPU) builds the
    histograms and later predicts; ``use_kernel`` as ``GBTRegressor``'s.
    Returns a ``PackedForest``.
    """
    device = resolve_device(device)
    use_kernel = _kernel_on(use_kernel, device)
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    assert X.ndim == 3 and Y.ndim == 3 and Y.shape[:2] == X.shape[:2]
    C, n, f = X.shape
    O = Y.shape[2]
    W = np.ones((C, n), np.float64) if W is None \
        else np.asarray(W, np.float64)
    L = C * O

    # -- per-candidate quantile binning (masked rows excluded) --------------
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    Xm = np.where(W[:, :, None] > 0, X, np.nan)
    edges = np.moveaxis(np.nanquantile(Xm, qs, axis=1), 0, -1)  # (C, f, E)
    bins_c = np.empty((C, n, f), np.int32)
    for c in range(C):
        for j in range(f):
            bins_c[c, :, j] = np.searchsorted(edges[c, j], X[c, :, j],
                                              side="right")
    bins = np.repeat(bins_c, O, axis=0)                       # (L, n, f)
    yT = np.moveaxis(Y, 2, 1).reshape(L, n)                   # l = c*O + o
    Wl = np.repeat(W, O, axis=0)
    # mean over the *compacted* included rows: np.mean sums pairwise, so
    # a padded weighted sum can differ in the last ulp and flip a split
    base = np.array([yT[l, Wl[l] > 0].mean() if (Wl[l] > 0).any() else 0.0
                     for l in range(L)])
    args = (bins, yT, Wl, base, n_estimators, learning_rate, max_depth,
            n_bins, min_child_weight, reg_lambda)
    if _resident_on(use_kernel, device, n_bins, max_depth):
        F, TH, LE, RI, V, NN = grow_forests(*args, device)
    else:
        F, TH, LE, RI, V, NN = _grow_forests_host(*args, use_kernel, device)

    def grid(a):
        return a.reshape(C, O, *a.shape[1:])

    return PackedForest(feature=grid(F), threshold=grid(TH), left=grid(LE),
                        right=grid(RI), value=grid(V), base=grid(base),
                        bin_edges=edges, n_nodes=grid(NN),
                        learning_rate=learning_rate, max_depth=max_depth,
                        device=str(device))


def _grow_forests_host(bins, yT, Wl, base, n_estimators, learning_rate,
                       max_depth, n_bins, min_child_weight, reg_lambda,
                       use_kernel, device):
    """``grow_forests``' trees grown by a host loop: each level's
    histograms from ``_joint_histograms``, the split search, the leaf
    values and the rows' next nodes in float64 numpy."""
    L, n, f = bins.shape
    lam = reg_lambda
    pred = np.broadcast_to(base[:, None], (L, n)).copy()
    N = 2 ** (max_depth + 1) - 1
    F = np.full((L, n_estimators, N), -1, np.int32)
    TH = np.zeros((L, n_estimators, N), np.int32)
    LE = np.zeros((L, n_estimators, N), np.int32)
    RI = np.zeros((L, n_estimators, N), np.int32)
    V = np.zeros((L, n_estimators, N), np.float32)
    NN = np.ones((L, n_estimators), np.int32)

    for t in range(n_estimators):
        F_t, TH_t, LE_t, RI_t, V_t = (a[:, t] for a in (F, TH, LE, RI, V))
        alive = Wl > 0
        grad = (pred - yT) * alive
        hess = Wl * alive
        node = np.zeros((L, n), np.int64)
        gid = np.zeros((L, 1), np.int64)
        valid = np.ones((L, 1), bool)
        next_free = np.ones(L, np.int64)

        for depth in range(max_depth + 1):
            nlvl = gid.shape[1]
            hist_g, hist_h = _joint_histograms(bins, grad, hess, node,
                                               nlvl, n_bins, use_kernel,
                                               device)
            Gtot = hist_g.sum(axis=-1)[..., 0]        # (L, nlvl)
            Htot = hist_h.sum(axis=-1)[..., 0]
            leaf_val = -Gtot / (Htot + lam)
            if depth == max_depth:
                li, lj = np.nonzero(valid)
                V_t[li, gid[li, lj]] = leaf_val[li, lj]
                break
            GL = np.cumsum(hist_g, axis=-1)
            HL = np.cumsum(hist_h, axis=-1)
            GR = Gtot[..., None, None] - GL
            HR = Htot[..., None, None] - HL
            gain = 0.5 * (GL ** 2 / (HL + lam) + GR ** 2 / (HR + lam)
                          - (Gtot ** 2 / (Htot + lam))[..., None, None])
            ok = (HL >= min_child_weight) & (HR >= min_child_weight)
            ok[..., -1] = False
            gain = np.where(ok, gain, -np.inf)
            flat = gain.reshape(L, nlvl, f * n_bins)
            best = flat.argmax(axis=-1)
            best_gain = np.take_along_axis(flat, best[..., None],
                                           axis=-1)[..., 0]
            best_f = (best // n_bins).astype(np.int64)
            best_b = (best % n_bins).astype(np.int64)
            split = valid & np.isfinite(best_gain) & (best_gain > 1e-12)

            li, lj = np.nonzero(valid & ~split)
            V_t[li, gid[li, lj]] = leaf_val[li, lj]
            if not split.any():
                break
            k = np.cumsum(split, axis=1)
            n_new = 2 * k[:, -1]
            base_local = 2 * (k - 1)                  # child level index
            si, sj = np.nonzero(split)
            sg = gid[si, sj]
            F_t[si, sg] = best_f[si, sj].astype(np.int32)
            TH_t[si, sg] = best_b[si, sj].astype(np.int32)
            LE_t[si, sg] = (next_free[si] + base_local[si, sj]) \
                .astype(np.int32)
            RI_t[si, sg] = (next_free[si] + base_local[si, sj] + 1) \
                .astype(np.int32)
            new_nlvl = int(n_new.max())
            gid = next_free[:, None] + np.arange(new_nlvl)[None, :]
            valid = np.arange(new_nlvl)[None, :] < n_new[:, None]
            next_free = next_free + n_new

            rsplit = np.take_along_axis(split, node, axis=1)
            bf = np.take_along_axis(best_f, node, axis=1)
            bthr = np.take_along_axis(best_b, node, axis=1)
            rowbin = np.take_along_axis(bins, np.maximum(bf, 0)[..., None],
                                        axis=2)[..., 0]
            go_right = rowbin > bthr
            nbase = np.take_along_axis(base_local, node, axis=1)
            node = np.where(rsplit, nbase + go_right, 0)
            alive &= rsplit
            grad *= alive
            hess *= alive

        NN[:, t] = np.minimum(next_free, N).astype(np.int32)

        # boosting update on the training rows (fixed-depth traversal)
        nd = np.zeros((L, n), np.int64)
        ftl = F_t.astype(np.int64)
        lfl = LE_t.astype(np.int64)
        rtl = RI_t.astype(np.int64)
        for _ in range(max_depth + 1):
            f_ = np.take_along_axis(ftl, nd, axis=1)
            isleaf = f_ < 0
            rb = np.take_along_axis(bins, np.maximum(f_, 0)[..., None],
                                    axis=2)[..., 0]
            go_left = rb <= np.take_along_axis(TH_t, nd, axis=1)
            nxt = np.where(go_left, np.take_along_axis(lfl, nd, axis=1),
                           np.take_along_axis(rtl, nd, axis=1))
            nd = np.where(isleaf, nd, nxt)
        # lr * float32 leaves, matching GBTRegressor.fit's dtype exactly
        pred = pred + learning_rate * np.take_along_axis(V_t, nd, axis=1)

    return F, TH, LE, RI, V, NN


class LinearRegression:
    """Ordinary least squares via normal equations (baseline #1)."""

    def fit(self, X, y):
        X = np.asarray(X, np.float64)
        Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        self.coef_, *_ = np.linalg.lstsq(Xb, np.asarray(y, np.float64),
                                         rcond=None)
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        Xb = np.concatenate([X, np.ones((len(X), 1))], axis=1)
        return Xb @ self.coef_
