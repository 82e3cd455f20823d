"""Plain PyTorch versions of K4's kernels: the gradient/hessian histograms
of one tree level, the split step that grows the level from them, and a
whole fit, level by level over the two."""
import math

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


def numpy_sum(a):
    """``np.sum(a, axis=-1)`` of float64 ``a`` with at most 128 values a
    row, in numpy's order: below 8 values a loop from 0.0; else eight
    running sums over the whole blocks of eight, combined as
    ``((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7))``, then the tail in order; the
    reduction adds the result to its initial 0.0."""
    n = a.shape[-1]
    if n > 128:
        raise ValueError(f"{n} values a row; numpy splits rows above 128")
    if n < 8:
        res = torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
        for i in range(n):
            res = res + a[..., i]
    else:
        r = [a[..., j] for j in range(8)]
        i = 8
        while i < n - n % 8:
            r = [r[j] + a[..., i + j] for j in range(8)]
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for i in range(i, n):
            res = res + a[..., i]
    return 0.0 + res


def first_argmax(x):
    """``np.argmax(x, axis=-1)``: the first NaN if the row holds one, else
    the first maximum."""
    nan = x.isnan()
    return torch.where(nan.any(-1), nan.int().argmax(-1),
                       torch.where(nan, -math.inf, x).argmax(-1))


def gbt_split_ref(hist, s, t: int, depth: int, max_depth: int,
                  reg_lambda: float, min_child_weight: float,
                  learning_rate: float) -> None:
    """The split step of one tree level (``ops.split_level``'s contract) on
    ``s``, an ``ops.GrowState``, in place.  ``hist`` (L, width, f, n_bins,
    2) fp32 holds the level's histograms.

    The numbers and their order are those of the host loop of
    ``core.gbt.fit_packed_forest``: float64 throughout, ``Gtot`` as numpy's
    pairwise sum over feature 0's bins, ``GL`` a sequential cumsum, the
    gain as written there, the first maximum of ``argmax`` (NaN first),
    leaf values rounded to float32, and ``pred + float32(lr) * leaf`` with
    the product in float32."""
    L, width, f, n_bins, _ = hist.shape
    dev = hist.device
    lam = reg_lambda
    h = hist.double()
    hg, hh = h[..., 0], h[..., 1]                       # (L, width, f, n_bins)
    first = s.level[:, 0].long()
    n_valid = s.level[:, 1].long()
    j = torch.arange(width, device=dev)
    valid = j[None] < n_valid[:, None]                  # (L, width)
    Gtot = numpy_sum(hg[:, :, 0])                       # (L, width)
    Htot = numpy_sum(hh[:, :, 0])
    leaf = (-Gtot / (Htot + lam)).float()
    split = torch.zeros_like(valid)
    bf = bb = torch.zeros((L, width), dtype=torch.long, device=dev)
    if depth < max_depth:
        GL, HL = torch.empty_like(hg), torch.empty_like(hh)
        GL[..., 0], HL[..., 0] = hg[..., 0], hh[..., 0]
        for b in range(1, n_bins):                      # np.cumsum's order
            GL[..., b] = GL[..., b - 1] + hg[..., b]
            HL[..., b] = HL[..., b - 1] + hh[..., b]
        GR = Gtot[..., None, None] - GL
        HR = Htot[..., None, None] - HL
        gain = 0.5 * (GL * GL / (HL + lam) + GR * GR / (HR + lam)
                      - (Gtot * Gtot / (Htot + lam))[..., None, None])
        ok = (HL >= min_child_weight) & (HR >= min_child_weight)
        ok[..., -1] = False
        flat = torch.where(ok, gain, -math.inf).reshape(L, width, f * n_bins)
        best = first_argmax(flat)
        best_gain = flat.gather(2, best[..., None])[..., 0]
        split = valid & best_gain.isfinite() & (best_gain > 1e-12)
        bf, bb = best // n_bins, best % n_bins
    tree = (s.feature[:, t], s.threshold[:, t], s.left[:, t], s.right[:, t],
            s.value[:, t])
    gid = first[:, None] + j
    li, lj = torch.nonzero(valid & ~split, as_tuple=True)
    tree[4][li, gid[li, lj]] = leaf[li, lj]
    k = torch.cumsum(split.long(), 1)
    n_new = 2 * k[:, -1]
    base_local = 2 * (k - 1)                            # child level index
    nxt = first + n_valid                               # the next free node
    si, sj = torch.nonzero(split, as_tuple=True)
    sg = gid[si, sj]
    tree[0][si, sg] = bf[si, sj].int()
    tree[1][si, sg] = bb[si, sj].int()
    tree[2][si, sg] = (nxt[si] + base_local[si, sj]).int()
    tree[3][si, sg] = (nxt[si] + base_local[si, sj] + 1).int()
    # rows: into a child, or into a leaf, which adds its value to pred
    nd = s.node.long()
    at = nd.clamp(min=0)
    rsplit = (nd >= 0) & split.gather(1, at)
    rleaf = (nd >= 0) & ~rsplit
    lr = torch.tensor(learning_rate, dtype=torch.float32)
    step = (leaf.gather(1, at) * lr.to(dev)).double()
    s.pred.copy_(torch.where(rleaf, s.pred + step, s.pred))
    rowbin = s.bins.long().gather(2, bf.gather(1, at)[..., None])[..., 0]
    go_right = (rowbin > bb.gather(1, at)).long()
    node = torch.where(rsplit, base_local.gather(1, at) + go_right, -1)
    if depth == max_depth:                              # the next tree
        N = s.value.shape[2]
        s.n_nodes[:, t] = nxt.clamp(max=N).int()
        live = s.w > 0
        s.grad.copy_(torch.where(live, (s.pred - s.y).float(), 0.0))
        node = torch.where(live, 0, -1)
        s.level.copy_(torch.tensor([0, 1], dtype=torch.int32,
                                   device=dev).expand(L, 2))
    else:
        s.level.copy_(torch.stack([nxt, n_new], 1).int())
    s.node.copy_(node.int())


def gbt_grow_ref(s, n_trees: int, max_depth: int, n_bins: int,
                 reg_lambda: float, min_child_weight: float,
                 learning_rate: float) -> None:
    """Trees 0 .. n_trees - 1 of the ``ops.GrowState`` ``s``, grown in place
    level by level: each level's histograms by ``gbt_hist_ref`` at the
    level's full width 2**depth, then ``gbt_split_ref``.  On the CPU the
    histograms add in row order, so this is ``ops.grow_fit``'s contract bit
    for bit; on a card ``index_add_``'s order varies."""
    for t in range(n_trees):
        for depth in range(max_depth + 1):
            hist = gbt_hist_ref(s.bins, s.grad, s.hess, s.node, 2 ** depth,
                                n_bins)
            gbt_split_ref(hist, s, t, depth, max_depth, reg_lambda,
                          min_child_weight, learning_rate)
