"""Public K4 wrappers: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors.

``build_node_histograms`` builds every tree node's histograms of one tree
level for L independent problems in one call (the reference made one
masked pass per node and a Python loop over problems).
``split_level`` grows the level from them on the device: the split search,
the leaf values, the tree entries and the rows' next nodes.  Together they
let ``core.gbt.grow_forests`` grow whole forests with no copy back to the
host until the end of the fit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gbt_hist.kernel import gbt_hist_lnf, gbt_split_l
from repro_torch.kernels.gbt_hist.ref import gbt_hist_ref, gbt_split_ref

# the split step follows numpy's pairwise sum only up to 128 values a row,
# and keeps a level's nodes in shared memory: 2**8 of them
SPLIT_MAX_BINS = 128
SPLIT_MAX_DEPTH = 8


def build_node_histograms(bins, grad, hess, node, n_nodes: int,
                          n_bins: int, out=None):
    """bins (L, n, f) int32; grad/hess (L, n) fp32; node (L, n) int32 ->
    (L, n_nodes, f, n_bins, 2) fp32 per-node gradient/hessian histograms,
    written into ``out`` when it is given.

    A row whose node or bin id lies outside its range adds nothing.  On
    CUDA tensors it launches the kernel or raises; each cell is then the
    fp32 sum of its rows in increasing row order, from +0.0.
    ``build_node_histograms.launches`` counts the launches."""
    if bins.dim() != 3:
        raise ValueError(f"bins must be (L, n, f), got {tuple(bins.shape)}")
    L, n, f = bins.shape
    for name, t in (("grad", grad), ("hess", hess), ("node", node)):
        if tuple(t.shape) != (L, n):
            raise ValueError(f"{name} is {tuple(t.shape)}, expected {(L, n)}")
    for name, t, dtype in (("bins", bins, torch.int32),
                           ("grad", grad, torch.float32),
                           ("hess", hess, torch.float32),
                           ("node", node, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}, expected {dtype}")
    if n_nodes < 1 or n_bins < 1:
        raise ValueError(f"n_nodes {n_nodes} and n_bins {n_bins} must be >= 1")
    shape = (L, n_nodes, f, n_bins, 2)
    if out is not None and (tuple(out.shape) != shape
                            or out.dtype != torch.float32
                            or out.device != bins.device
                            or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous float32 {shape} on "
                         f"{bins.device}")
    tensors = (bins, grad, hess, node)
    if all(t.device.type == "cpu" for t in tensors):
        h = gbt_hist_ref(bins, grad, hess, node, n_nodes, n_bins)
        return h if out is None else out.copy_(h)
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"build_node_histograms: bins on {dev}")
    for name, t in zip(("bins", "grad", "hess", "node"), tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}, is on "
                             f"{t.device} with strides {t.stride()}")
    if max(L, f) > 65535:
        raise ValueError(f"L {L} and f {f} must be at most 65535 (grid)")
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=dev)
    if out.numel():
        gbt_hist_lnf(bins, grad, hess, node, out, n_nodes, n_bins)
        build_node_histograms.launches += 1
    return out


build_node_histograms.launches = 0


@dataclasses.dataclass(frozen=True)
class GrowState:
    """What a fit of L problems keeps on its device while it grows T trees
    of at most N = 2**(max_depth + 1) - 1 nodes each.  ``split_level``
    updates the tensors in place; none is ever replaced.

    A row is in the fit where ``w > 0``.  ``node`` holds a row's node within
    the current level, or -1 once the row sits in a leaf (or is out of the
    fit), so the histograms skip it.  ``level[l]`` is (id of the level's
    first node in the tree, number of valid nodes in the level).  The tree
    arrays are those of ``core.gbt.PackedForest``, by problem."""
    bins: torch.Tensor       # (L, n, f) int32
    y: torch.Tensor          # (L, n) float64 targets
    w: torch.Tensor          # (L, n) float64 row weights
    pred: torch.Tensor       # (L, n) float64 running predictions
    grad: torch.Tensor       # (L, n) float32 gradients of the current tree
    hess: torch.Tensor       # (L, n) float32
    node: torch.Tensor       # (L, n) int32
    level: torch.Tensor      # (L, 2) int32
    feature: torch.Tensor    # (L, T, N) int32, -1 for a leaf
    threshold: torch.Tensor  # (L, T, N) int32
    left: torch.Tensor       # (L, T, N) int32
    right: torch.Tensor      # (L, T, N) int32
    value: torch.Tensor      # (L, T, N) float32
    n_nodes: torch.Tensor    # (L, T) int32

    def __post_init__(self):
        L, n, f = self.bins.shape
        T, N = self.value.shape[1:]
        dev = self.bins.device
        i32, f32, f64 = torch.int32, torch.float32, torch.float64
        for name, shape, dtype in (
                ("bins", (L, n, f), i32), ("y", (L, n), f64),
                ("w", (L, n), f64), ("pred", (L, n), f64),
                ("grad", (L, n), f32), ("hess", (L, n), f32),
                ("node", (L, n), i32), ("level", (L, 2), i32),
                ("feature", (L, T, N), i32), ("threshold", (L, T, N), i32),
                ("left", (L, T, N), i32), ("right", (L, T, N), i32),
                ("value", (L, T, N), f32), ("n_nodes", (L, T), i32)):
            t = getattr(self, name)
            if (tuple(t.shape) != shape or t.dtype != dtype
                    or t.device != dev or not t.is_contiguous()):
                raise ValueError(
                    f"GrowState.{name} must be a contiguous {dtype} {shape} "
                    f"on {dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
        if N & (N + 1) or N < 1:
            raise ValueError(f"N {N} is not 2**(max_depth + 1) - 1")

    @classmethod
    def start(cls, bins, y, w, base, n_trees: int, max_depth: int,
              device) -> "GrowState":
        """The state before the first tree, on ``device``, from numpy bins
        (L, n, f), targets y and weights w (L, n) and starting predictions
        base (L,): every row in the fit at the root with gradient
        float32((base - y) * (w > 0)) and hessian float32(w * (w > 0)), as
        the host loop's first tree has them."""
        L, n, f = bins.shape
        N = 2 ** (max_depth + 1) - 1
        in_fit = w > 0
        pred = np.broadcast_to(np.asarray(base, np.float64)[:, None], (L, n))

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        trees = torch.zeros((4, L, n_trees, N), dtype=torch.int32,
                            device=device)
        trees[0] = -1
        return cls(
            bins=put(bins, np.int32), y=put(y, np.float64),
            w=put(w, np.float64), pred=put(pred, np.float64),
            grad=put((pred - y) * in_fit, np.float32),
            hess=put(w * in_fit, np.float32),
            node=put(np.where(in_fit, 0, -1), np.int32),
            level=put(np.broadcast_to([0, 1], (L, 2)), np.int32),
            feature=trees[0], threshold=trees[1], left=trees[2],
            right=trees[3],
            value=torch.zeros((L, n_trees, N), dtype=torch.float32,
                              device=device),
            n_nodes=torch.ones((L, n_trees), dtype=torch.int32,
                               device=device))


def split_level(hist, s: GrowState, t: int, depth: int, max_depth: int,
                reg_lambda: float, min_child_weight: float,
                learning_rate: float) -> None:
    """Grows level ``depth`` of tree ``t`` of every problem of ``s`` from
    its histograms ``hist`` (L, 2**depth, f, n_bins, 2) fp32, in place.

    For every valid node: ``Gtot``, ``Htot``, its leaf value and its best
    (feature, bin) by the gain of ``core.gbt.fit_packed_forest``; a node
    splits where that gain is finite and above 1e-12 (never at
    ``max_depth``).  Split nodes get their ``feature``, ``threshold`` and
    children numbered in node order after the level; the others their leaf
    value.  Rows of a split node move to a child; rows of a leaf add
    ``float32(learning_rate) * value`` to ``pred`` and leave the tree.
    After the last level the tree's ``n_nodes`` is written and every row in
    the fit starts the next tree at the root with its new gradient.  The
    float64 arithmetic is numpy's, in numpy's order, so the trees are the
    host loop's bit for bit.  On CUDA tensors it launches the kernel or
    raises; ``split_level.launches`` counts the launches."""
    L, n, f = s.bins.shape
    T, N = s.value.shape[1:]
    width = 2 ** depth
    n_bins = hist.shape[3] if hist.dim() == 5 else 0
    if (tuple(hist.shape) != (L, width, f, n_bins, 2)
            or hist.dtype != torch.float32 or hist.device != s.bins.device
            or not hist.is_contiguous()):
        raise ValueError(f"hist must be a contiguous float32 "
                         f"{(L, width, f, 'n_bins', 2)} on {s.bins.device}; "
                         f"got {hist.dtype} {tuple(hist.shape)} on "
                         f"{hist.device}")
    if not 1 <= n_bins <= SPLIT_MAX_BINS:
        raise ValueError(f"n_bins {n_bins} outside 1..{SPLIT_MAX_BINS}")
    if not 0 <= depth <= max_depth <= SPLIT_MAX_DEPTH \
            or N != 2 ** (max_depth + 1) - 1:
        raise ValueError(f"depth {depth}, max_depth {max_depth} (at most "
                         f"{SPLIT_MAX_DEPTH}) and N {N} do not fit")
    if not 0 <= t < T:
        raise ValueError(f"tree {t} outside 0..{T - 1}")
    if s.bins.device.type == "cpu":
        gbt_split_ref(hist, s, t, depth, max_depth, reg_lambda,
                      min_child_weight, learning_rate)
        return
    if s.bins.device.type != "cuda":
        raise ValueError(f"split_level: state on {s.bins.device}")
    if L > 2 ** 31 - 1:
        raise ValueError(f"L {L} exceeds the grid")
    if L:
        gbt_split_l(hist, s, t, depth == max_depth, float(reg_lambda),
                    float(min_child_weight), float(learning_rate))
        split_level.launches += 1


split_level.launches = 0
