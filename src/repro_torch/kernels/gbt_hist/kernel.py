"""ctypes bindings of K4's CUDA kernels: the histograms and the split step.

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
    return lib, hist, split


def gbt_hist_lnf(bins, grad, hess, node, out, n_nodes: int,
                 n_bins: int) -> None:
    """bins (L, n, f), grad/hess/node (L, n), out (L, n_nodes, f, n_bins,
    2), all contiguous on one card, checked by the caller."""
    lib, fn, _ = _entry()
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
    lib, _, fn = _entry()
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
