"""ctypes bindings of K4's CUDA kernels: a whole fit in one launch, and the
histograms and the split step of the level-by-level path.

The kernels are ``csrc/gbt_hist.cu`` (its header comment says what they
replace, what bounds them and what they guarantee); it is compiled at the
first launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _entry():
    lib = _build.load("gbt_hist")
    hist = lib.gbt_hist
    hist.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    hist.restype = ctypes.c_int
    split = lib.gbt_split
    split.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 9
                      + [ctypes.c_double] * 2 + [ctypes.c_float, ctypes.c_void_p])
    split.restype = ctypes.c_int
    grow = lib.gbt_grow
    grow.argtypes = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
                     + [ctypes.c_double] * 2 + [ctypes.c_float, ctypes.c_void_p])
    grow.restype = ctypes.c_int
    lib.gbt_grow_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.gbt_grow_smem_bytes.restype = ctypes.c_longlong
    lib.gbt_grow_plan.argtypes = [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    lib.gbt_grow_plan.restype = ctypes.c_int
    return lib, hist, split, grow


def gbt_hist_lnf(bins, grad, hess, node, out, n_nodes: int,
                 n_bins: int) -> None:
    """bins (L, n, f), grad/hess/node (L, n), out (L, n_nodes, f, n_bins,
    2), all contiguous on one card, checked by the caller."""
    lib, fn, _, _ = _entry()
    L, n, f = bins.shape
    code = fn(bins.data_ptr(), grad.data_ptr(), hess.data_ptr(),
              node.data_ptr(), out.data_ptr(), L, n, f, n_nodes, n_bins,
              torch.cuda.current_stream(bins.device).cuda_stream)
    _build.check(lib, code, "gbt_hist")


def gbt_split_l(hist, s, t: int, last: bool, reg_lambda: float,
                min_child_weight: float, learning_rate: float) -> None:
    """The split step on ``hist`` (L, width, f, n_bins, 2) and the
    ``ops.GrowState`` ``s``, all contiguous on one card, checked by the
    caller."""
    lib, _, fn, _ = _entry()
    L, width, f, n_bins, _ = hist.shape
    n = s.bins.shape[1]
    T, N = s.value.shape[1:]
    code = fn(*(x.data_ptr() for x in (
        hist, s.bins, s.y, s.w, s.pred, s.grad, s.node, s.level, s.feature,
        s.threshold, s.left, s.right, s.value, s.n_nodes)),
        L, width, n, f, n_bins, T, N, t, int(last), reg_lambda,
        min_child_weight, learning_rate,
        torch.cuda.current_stream(hist.device).cuda_stream)
    _build.check(lib, code, "gbt_split")


def gbt_grow_l(s, max_depth: int, n_bins: int, reg_lambda: float,
               min_child_weight: float, learning_rate: float) -> None:
    """Grows every tree of the ``ops.GrowState`` ``s`` in one launch, all
    contiguous on one card, checked by the caller."""
    lib, _, _, fn = _entry()
    L, n, f = s.bins.shape
    T = s.value.shape[1]
    code = fn(*(x.data_ptr() for x in (
        s.bins, s.y, s.w, s.pred, s.grad, s.hess, s.node, s.level, s.feature,
        s.threshold, s.left, s.right, s.value, s.n_nodes)),
        L, n, f, n_bins, T, max_depth, reg_lambda, min_child_weight,
        learning_rate, torch.cuda.current_stream(s.bins.device).cuda_stream)
    _build.check(lib, code, "gbt_grow")


def grow_smem_bytes(n: int, f: int, n_bins: int, max_depth: int,
                    most: int) -> int:
    """The built kernel's own count of a gbt_grow block's shared memory for
    clusters of at most ``most`` blocks (-1 for a fit it does not take):
    ``ops.grow_smem_bytes`` must agree."""
    return int(_entry()[0].gbt_grow_smem_bytes(n, f, n_bins, max_depth,
                                               most))


def grow_plan(L: int, n: int, f: int, n_bins: int, max_depth: int) -> tuple:
    """(most, shared memory a block) that gbt_grow takes for a fit of L
    problems on the current card, its cluster ``ops.grow_split(f, most)``;
    raises for a fit it cannot hold."""
    lib = _entry()[0]
    most, smem = ctypes.c_int(), ctypes.c_longlong()
    code = lib.gbt_grow_plan(L, n, f, n_bins, max_depth, ctypes.byref(most),
                             ctypes.byref(smem))
    _build.check(lib, code, "gbt_grow_plan")
    return most.value, smem.value
