"""Plain PyTorch version of the GBT gradient/hessian histograms."""
import torch


def gbt_hist_ref(bins, grad, hess, node, n_nodes: int, n_bins: int):
    """bins (L, n, f) int32; grad/hess (L, n) fp32; node (L, n) int32 ->
    (L, n_nodes, f, n_bins, 2) fp32.

    ``index_add_`` over the flat cell index, in fp32.  A row whose node or
    bin id lies outside its range adds nothing (it lands in a spare cell
    that is dropped).  On the CPU the adds run in row order, as K4's do."""
    L, n, f = bins.shape
    size = L * n_nodes * f * n_bins
    dev = bins.device
    b = bins.long()
    nd = node.long()[:, :, None]
    ok = (nd >= 0) & (nd < n_nodes) & (b >= 0) & (b < n_bins)
    lid = torch.arange(L, device=dev)[:, None, None]
    flat = ((lid * n_nodes + nd) * f + torch.arange(f, device=dev)) * n_bins + b
    flat = torch.where(ok, flat, size).reshape(-1)
    sums = []
    for w in (grad, hess):
        acc = torch.zeros(size + 1, dtype=torch.float32, device=dev)
        acc.index_add_(0, flat, w.float()[:, :, None].expand(L, n, f).reshape(-1))
        sums.append(acc[:size])
    return torch.stack(sums, dim=-1).reshape(L, n_nodes, f, n_bins, 2)
