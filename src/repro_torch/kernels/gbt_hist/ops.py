"""Public GBT-histogram wrapper: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors.

One call builds every tree node's histograms of one tree level for L
independent problems at once (the reference made one masked pass per
node and a Python loop over problems).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.gbt_hist.kernel import gbt_hist_lnf
from repro_torch.kernels.gbt_hist.ref import gbt_hist_ref


def build_node_histograms(bins, grad, hess, node, n_nodes: int,
                          n_bins: int):
    """bins (L, n, f) int32; grad/hess (L, n) fp32; node (L, n) int32 ->
    (L, n_nodes, f, n_bins, 2) fp32 per-node gradient/hessian histograms.

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
    tensors = (bins, grad, hess, node)
    if all(t.device.type == "cpu" for t in tensors):
        return gbt_hist_ref(bins, grad, hess, node, n_nodes, n_bins)
    dev = bins.device
    if dev.type != "cuda":
        raise ValueError(f"build_node_histograms: bins on {dev}")
    for name, t in zip(("bins", "grad", "hess", "node"), tensors):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}, is on "
                             f"{t.device} with strides {t.stride()}")
    if max(L, f) > 65535:
        raise ValueError(f"L {L} and f {f} must be at most 65535 (grid)")
    out = torch.empty((L, n_nodes, f, n_bins, 2), dtype=torch.float32,
                      device=dev)
    if out.numel():
        gbt_hist_lnf(bins, grad, hess, node, out, n_nodes, n_bins)
        build_node_histograms.launches += 1
    return out


build_node_histograms.launches = 0
