"""Public K4 wrappers: the CUDA kernels for CUDA tensors, the plain
versions for CPU tensors.

``build_node_histograms`` builds every tree node's histograms of one tree
level for L independent problems in one call (the reference made one
masked pass per node and a Python loop over problems).
``split_level`` grows the level from them on the device: the split search,
the leaf values, the tree entries and the rows' next nodes.  ``grow_fit``
grows a whole fit in one launch, its state in a thread-block cluster's
shared memory, for every fit that ``fits_on_chip`` accepts; the other two
grow larger fits level by level.  So ``core.gbt.grow_forests`` grows whole
forests with no copy back to the host until the end of the fit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.gbt_hist.kernel import (gbt_grow_l, gbt_hist_lnf,
                                                 gbt_split_l)
from repro_torch.kernels.gbt_hist.ref import (gbt_grow_ref, gbt_hist_ref,
                                              gbt_split_ref)

# the split step follows numpy's pairwise sum only up to 128 values a row,
# and keeps a level's nodes in shared memory: 2**8 of them
SPLIT_MAX_BINS = 128
SPLIT_MAX_DEPTH = 8
# gbt_grow (csrc/gbt_hist.cu): blocks of 256 threads, at most 8 a cluster
# (the portable size), 16-bit row ids, and the shared memory an H100 block
# can have (227 KB).  The library picks each fit's cluster from what the
# card holds at once (``gbt_grow_plan``); here only whether some cluster
# holds the fit.
GROW_THREADS = 256
GROW_MAX_CLUSTER = 8
GROW_MAX_ROWS = 65_535
GROW_SMEM = 232_448


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
        self.check()

    def check(self) -> None:
        """Raises unless every tensor has its shape and dtype, contiguous on
        one device, and N is a full tree's node count."""
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


def grow_split(f: int, most: int) -> tuple:
    """(features a block, blocks) of ``grow_fit``'s cluster for f features
    over at most ``most`` blocks, block r owning features r * per ..
    (r + 1) * per: the kernel's ``grow_split``."""
    per = -(-f // most)
    return per, -(-f // per)


def grow_smem_bytes(n: int, f: int, n_bins: int, max_depth: int,
                    most: int) -> int:
    """The shared memory of one ``grow_fit`` block, in bytes, for clusters
    of at most ``most`` blocks: the kernel's ``grow_layout``
    (csrc/gbt_hist.cu), each array rounded up to 8 bytes.  Per row: pred 8,
    node, grad and hess 4 each, every feature's bin id 1, and a 2-byte id
    for each histogram feature (its own and feature 0); the histograms of
    the widest searching level's nodes (or the last level's, feature 0
    alone), and per-node and per-thread scratch."""
    per, blocks = grow_split(f, most)
    nh = per + (blocks > 1)
    W = 2 ** max_depth
    WS = max(1, W // 2)
    stride = n_bins | 1
    hist_rows = max(nh * WS if max_depth else 0, W)
    sizes = (8 * n, 8 * hist_rows * stride, 8 * W, 8 * W, 8 * W,
             8 * 2 * blocks * WS, 8 * GROW_THREADS, 4 * n, 4 * n, 4 * n,
             4 * W, 4 * W, 4 * W, 4 * W, 4 * W, 4 * 2 * blocks * WS,
             4 * GROW_THREADS, 4 * (GROW_THREADS // 32),
             4 * nh * (n_bins + 1), 2 * nh * n, n * f)
    return sum(-(-b // 8) * 8 for b in sizes)


def fits_on_chip(L: int, n: int, f: int, n_bins: int, max_depth: int) -> bool:
    """Whether ``grow_fit`` takes a fit of L problems of n rows, f features
    and n_bins bins with trees of max_depth: within the split step's limits,
    16-bit row ids, and some cluster's block within an H100 block's shared
    memory (the kernel's ``gbt_grow_plan`` chooses among those).  A pure
    function of the shapes."""
    if not (1 <= L <= (2 ** 31 - 1) // GROW_MAX_CLUSTER
            and 0 <= n <= GROW_MAX_ROWS and f >= 1
            and 1 <= n_bins <= SPLIT_MAX_BINS
            and 0 <= max_depth <= SPLIT_MAX_DEPTH):
        return False
    return min(grow_smem_bytes(n, f, n_bins, max_depth, most)
               for most in range(1, min(f, GROW_MAX_CLUSTER) + 1)) <= GROW_SMEM


def grow_fit(state: GrowState, n_trees: int, max_depth: int, n_bins: int,
             reg_lambda: float, min_child_weight: float,
             learning_rate: float) -> None:
    """Grows the ``n_trees`` trees (the state's T) of every problem of
    ``state`` in place, as ``n_trees * (max_depth + 1)`` pairs of
    ``build_node_histograms`` (at each level's full width 2**depth) and
    ``split_level`` would, bit for bit: the tree arrays, and the rows' pred,
    grad and node and the level they leave.

    On CUDA tensors it launches ``gbt_grow`` once, one thread-block cluster
    a problem of the size the library's ``gbt_grow_plan`` picks for the
    card (``fits_on_chip`` must accept the fit), or raises;
    ``grow_fit.launches`` counts the launches.  On CPU tensors it runs the
    plain version, ``ref.gbt_grow_ref``."""
    if not isinstance(state, GrowState):
        raise TypeError(f"state must be a GrowState, got {type(state)}")
    state.check()
    L, n, f = state.bins.shape
    T, N = state.value.shape[1:]
    if not 1 <= n_bins <= SPLIT_MAX_BINS:
        raise ValueError(f"n_bins {n_bins} outside 1..{SPLIT_MAX_BINS}")
    if not 0 <= max_depth <= SPLIT_MAX_DEPTH \
            or N != 2 ** (max_depth + 1) - 1:
        raise ValueError(f"max_depth {max_depth} (at most {SPLIT_MAX_DEPTH}) "
                         f"and the state's {N} nodes a tree do not fit")
    if n_trees != T:
        raise ValueError(f"n_trees {n_trees}: the state holds {T} trees")
    dev = state.bins.device
    if dev.type == "cpu":
        gbt_grow_ref(state, n_trees, max_depth, n_bins, reg_lambda,
                     min_child_weight, learning_rate)
        return
    if dev.type != "cuda":
        raise ValueError(f"grow_fit: state on {dev}")
    if not fits_on_chip(L, n, f, n_bins, max_depth):
        raise ValueError(
            f"grow_fit: a fit of L {L}, n {n}, f {f}, {n_bins} bins, depth "
            f"{max_depth} exceeds the kernel's limits or {GROW_SMEM} B of "
            f"shared memory a block; grow it level by level")
    if n_trees:
        gbt_grow_l(state, max_depth, n_bins, float(reg_lambda),
                   float(min_child_weight), float(learning_rate))
        grow_fit.launches += 1


grow_fit.launches = 0
