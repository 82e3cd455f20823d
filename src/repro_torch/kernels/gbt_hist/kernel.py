"""ctypes binding of the CUDA GBT-histogram kernel.

The kernel is ``csrc/gbt_hist.cu`` (its header comment says what it
replaces, what bounds it and what it guarantees); it is compiled at the
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
    fn = lib.gbt_hist
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def gbt_hist_lnf(bins, grad, hess, node, out, n_nodes: int,
                 n_bins: int) -> None:
    """bins (L, n, f), grad/hess/node (L, n), out (L, n_nodes, f, n_bins,
    2), all contiguous on one card, checked by the caller."""
    lib, fn = _entry()
    L, n, f = bins.shape
    code = fn(bins.data_ptr(), grad.data_ptr(), hess.data_ptr(),
              node.data_ptr(), out.data_ptr(), L, n, f, n_nodes, n_bins,
              torch.cuda.current_stream(bins.device).cuda_stream)
    _build.check(lib, code, "gbt_hist")
