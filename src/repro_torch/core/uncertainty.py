"""Uncertainty quantification (paper Alg 8) — serial and batched engines.

Confidence c = 1 / (1 + d_min), where d_min is the minimum over logged SA
subsets of the average per-feature *histogram cosine distance* between the
new workload's (ii, oo, bb, thpt) distribution and the subset's rows.
Workload features are histogrammed in log space (they span decades);
throughput in linear space.

Two paths share the metric:

  * ``confidence``      — the original serial loop.  Bin edges are
    recomputed from the union range of every (query, subset) pair, and
    each pair re-histograms both row sets.  O(S) pipeline passes per
    query; fine for one-off estimates.
  * ``SubsetBank``      — the fleet-scale engine.  Built once per SA
    log: subset row-masks materialize in one vectorized pass, bin edges
    are fixed from the training rows, and every subset's per-feature
    histograms precompute into an (S, 4, B) array.  Queries then run on
    the device (searchsorted on the float32 edges -> ``scatter_add_``
    count histograms -> normalized dot products in one einsum), which
    emits the full (n_queries x n_subsets) cosine-distance matrix at
    once.  ``bank_distances(..., backend="numpy")`` is the serial float64
    reference for the same fixed-bin contract; the torch path matches it
    to <= 1e-6.

Degenerate logs (every subset selects < 2 training rows) surface
explicitly in both paths: d_min = inf, confidence = 0.0 — never the
misleading mid-scale fallback of pretending d_min = 1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.annealing import (SALog, Subset, batch_subset_masks,
                                        subset_mask)
from repro_torch.device import resolve_device

N_HIST_BINS = 16
FEATS = ("ii", "oo", "bb", "thpt")
MIN_SUBSET_ROWS = 2
# both engines reduce d_min over the same trailing window of the SA log
# by default, and it bounds bank memory on long multi-chain runs
DEFAULT_MAX_SUBSETS = 200
# weight of the hardware-descriptor distance when a fit is queried on
# hardware it was not benchmarked on: the effective Alg 8 distance is
# d_eff = d_min + HW_DIST_WEIGHT * d_hw before the 1/(1+d) squash, so
# any d_hw > 0 strictly lowers confidence on identical workloads (the
# reference's perfmodel/hardware.py::hardware_distance sets the d_hw scale)
HW_DIST_WEIGHT = 1.0


def _feature_bins(ref: Dict[str, np.ndarray],
                  new: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    bins = {}
    for f in FEATS:
        allv = np.concatenate([ref[f], new[f]]).astype(np.float64)
        if f == "thpt":
            lo, hi = float(allv.min()), float(allv.max())
            hi = hi if hi > lo else lo + 1.0
            bins[f] = np.linspace(lo, hi, N_HIST_BINS + 1)
        else:
            lo = max(float(allv.min()), 1e-9)
            hi = max(float(allv.max()), lo * (1 + 1e-9))
            bins[f] = np.geomspace(lo, hi * (1 + 1e-9), N_HIST_BINS + 1)
    return bins


def _hist(vals: np.ndarray, edges: np.ndarray) -> np.ndarray:
    h, _ = np.histogram(np.asarray(vals, np.float64), bins=edges)
    h = h.astype(np.float64)
    s = h.sum()
    return h / s if s > 0 else h


def _cosine_distance(u: np.ndarray, v: np.ndarray) -> float:
    nu, nv = np.linalg.norm(u), np.linalg.norm(v)
    if nu == 0 or nv == 0:
        return 1.0
    return float(1.0 - np.dot(u, v) / (nu * nv))


def workload_distance(ref_rows: Dict[str, np.ndarray],
                      new_rows: Dict[str, np.ndarray]) -> float:
    """Average per-feature histogram cosine distance between two row sets."""
    bins = _feature_bins(ref_rows, new_rows)
    ds = []
    for f in FEATS:
        ds.append(_cosine_distance(_hist(ref_rows[f], bins[f]),
                                   _hist(new_rows[f], bins[f])))
    return float(np.mean(ds))


def confidence(train, log: SALog, new,
               max_subsets: int = DEFAULT_MAX_SUBSETS,
               hw_dist: float = 0.0) -> Tuple[float, float]:
    """Alg 8 lines 4-6: (d_min, confidence) for a new workload.

    ``train``/``new`` are (ii, oo, bb, thpt) tuples; logged subsets are
    materialized as row-sets of the training data they selected.
    Subsets selecting fewer than ``MIN_SUBSET_ROWS`` rows carry no
    distributional signal and are skipped; when *every* subset is
    skipped the log is degenerate and the result is the explicit
    sentinel ``(inf, 0.0)`` — same contract as the batched path.
    """
    ii, oo, bb, thpt = train
    nii, noo, nbb, nthpt = new
    new_rows = {"ii": nii, "oo": noo, "bb": nbb, "thpt": nthpt}
    subsets = log.subsets[-max_subsets:]
    d_min = np.inf
    for s in subsets:
        m = subset_mask(ii, oo, bb, s)
        if m.sum() < MIN_SUBSET_ROWS:
            continue
        ref_rows = {"ii": ii[m], "oo": oo[m], "bb": bb[m], "thpt": thpt[m]}
        d = workload_distance(ref_rows, new_rows)
        d_min = min(d_min, d)
    return float(d_min), confidence_from_dmin(d_min, hw_dist)


def confidence_from_dmin(d_min: float, hw_dist: float = 0.0) -> float:
    """1 / (1 + d_min + HW_DIST_WEIGHT * hw_dist), with the degenerate
    d_min = inf mapping to 0.0.  ``hw_dist`` is the hardware-descriptor
    distance between the queried hardware and the hardware the fit was
    benchmarked on (0 for same-hardware queries)."""
    if not np.isfinite(d_min):
        return 0.0
    return float(1.0 / (1.0 + d_min + HW_DIST_WEIGHT * hw_dist))


# ---------------------------------------------------------------------------
# SubsetBank: fixed-shape histograms + the batched distance kernel
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SubsetBank:
    """Precomputed fixed-shape state for batched Alg 8 queries.

    Built once per (train, SALog) pair.  The *fixed-bin contract*: bin
    edges derive from the training rows only (log-space for ii/oo/bb,
    linear for thpt), values outside the range clip into the boundary
    bins, and bin *assignment* compares float32 values against float32
    edges — identically in the serial numpy reference and the device
    path, so both paths count the exact same histograms and differ
    only by float32-vs-float64 rounding in the cosine arithmetic.
    """
    inner_edges: np.ndarray     # (4, B-1) float32 bucketize edges
    hist: np.ndarray            # (S, 4, B) float64 subset count histograms
    unit: np.ndarray            # (S, 4, B) float32 L2-normalized histograms
    valid: np.ndarray           # (S,) bool — >= MIN_SUBSET_ROWS rows selected
    masks: np.ndarray           # (S, n) bool training-row masks
    subsets: List[Subset]
    universes: Dict[str, np.ndarray]
    n_bins: int

    @property
    def n_subsets(self) -> int:
        return len(self.subsets)


def _bank_edges(train, n_bins: int) -> np.ndarray:
    """(4, B-1) float32 inner edges: geomspace for ii/oo/bb, linspace
    for thpt, ranges from the (finite) training rows.

    The two boundary bins are *reserved for out-of-range values*: the
    training range [lo, hi] splits into the B-2 core bins, the first
    inner edge sits at lo (side="right" keeps v == lo in the core) and
    the last one ulp above hi.  Training rows therefore never occupy
    bins 0 / B-1, so a query far outside the range concentrates in a
    bin no valid subset has mass in and reads as distant — out-of-range
    mass is flagged, not silently merged with the training extremes.
    """
    cols = dict(zip(FEATS, (np.asarray(v, np.float64) for v in train)))
    inner = np.empty((len(FEATS), n_bins - 1), np.float32)
    for fi, f in enumerate(FEATS):
        v = cols[f][np.isfinite(cols[f])]
        if f == "thpt":
            lo = float(v.min()) if len(v) else 0.0
            hi = float(v.max()) if len(v) else 1.0
            hi = hi if hi > lo else lo + 1.0
            core = np.linspace(lo, hi, n_bins - 1)[1:-1]
        else:
            lo = max(float(v.min()), 1e-9) if len(v) else 1e-9
            hi = max(float(v.max()), lo * (1 + 1e-9)) if len(v) else 1.0
            core = np.geomspace(lo, hi, n_bins - 1)[1:-1]
        lo32, hi32 = np.float32(lo), np.float32(hi)
        edges = np.concatenate(
            [[lo32], core.astype(np.float32),
             [np.nextafter(hi32, np.float32(np.inf))]])
        # float32 rounding of near-equal float64 edges must stay sorted
        inner[fi] = np.maximum.accumulate(edges)
    return inner


def _bucketize(vals: np.ndarray, inner_f32: np.ndarray) -> np.ndarray:
    """Fixed-bin assignment (float32 compare, clipping out-of-range
    values into the boundary bins).  Identical semantics to the device
    path's torch.searchsorted(right=True)."""
    return np.searchsorted(inner_f32,
                           np.asarray(vals, np.float32), side="right") \
        .astype(np.int32)


def _count_hist(vals: np.ndarray, inner_f32: np.ndarray,
                n_bins: int, weights: Optional[np.ndarray] = None
                ) -> np.ndarray:
    """Float64 count histogram of the finite values (fixed bins)."""
    vals = np.asarray(vals, np.float64)
    finite = np.isfinite(vals)
    w = finite.astype(np.float64) if weights is None \
        else finite * np.asarray(weights, np.float64)
    bins = _bucketize(np.where(finite, vals, 0.0), inner_f32)
    return np.bincount(bins, w, minlength=n_bins).astype(np.float64)


def _finalize_bank(inner, hist, masks, subsets, universes,
                   n_bins: int) -> SubsetBank:
    """L2-normalize + validity flags — shared bank assembly tail."""
    nrm = np.linalg.norm(hist, axis=2, keepdims=True)
    unit = (hist / np.maximum(nrm, 1e-30)).astype(np.float32)
    valid = masks.sum(axis=1) >= MIN_SUBSET_ROWS
    return SubsetBank(inner_edges=inner, hist=hist, unit=unit, valid=valid,
                      masks=masks, subsets=subsets,
                      universes={k: np.asarray(v)
                                 for k, v in universes.items()},
                      n_bins=n_bins)


def _onehot_bins(cols, inner: np.ndarray, n_bins: int) -> np.ndarray:
    """(4, n, B) one-hot bin assignment of the rows under fixed edges
    (non-finite values carry no mass)."""
    n = len(cols[0])
    out = np.zeros((len(FEATS), n, n_bins), np.float64)
    for fi, col in enumerate(cols):
        finite = np.isfinite(col)
        bins = _bucketize(np.where(finite, col, 0.0), inner[fi])
        out[fi, np.arange(n)[finite], bins[finite]] = 1.0
    return out


def build_subset_bank(train, log: SALog,
                      max_subsets: Optional[int] = DEFAULT_MAX_SUBSETS,
                      n_bins: int = N_HIST_BINS,
                      inner_edges: Optional[np.ndarray] = None) -> SubsetBank:
    """Materialize the SA log into fixed-shape arrays, once.

    Row masks come from one vectorized membership pass
    (``batch_subset_masks``); per-subset histograms are a single
    (S, n) @ (n, B) matmul per feature (exact integer counts in
    float64).  ``inner_edges`` overrides the training-derived bin edges
    — the hook ``extend_bank`` parity checks use, and the way an online
    refit can pin the original fixed-bin contract across data epochs.
    """
    ii, oo, bb, thpt = (np.asarray(v, np.float64) for v in train)
    subsets = list(log.subsets[-max_subsets:] if max_subsets
                   else log.subsets)
    masks = batch_subset_masks(ii, oo, bb, subsets, log.universes)
    inner = (_bank_edges((ii, oo, bb, thpt), n_bins)
             if inner_edges is None else np.asarray(inner_edges, np.float32))

    cols = (ii, oo, bb, thpt)
    onehot = _onehot_bins(cols, inner, n_bins)
    masks_f = masks.astype(np.float64)
    hist = np.einsum("sn,fnb->sfb", masks_f, onehot)
    return _finalize_bank(inner, hist, masks, subsets, log.universes,
                          n_bins)


def extend_bank(bank: SubsetBank, train, n_delta: int,
                new_subsets: Sequence[Subset],
                universes: Dict[str, np.ndarray],
                max_subsets: Optional[int] = DEFAULT_MAX_SUBSETS
                ) -> SubsetBank:
    """Incrementally grow a bank after rows were *appended* to the
    training data and new subsets were logged (one online refit epoch).

    ``train`` is the full concatenated (ii, oo, bb, thpt); its last
    ``n_delta`` rows are the appended delta (the prefix must be the rows
    the bank was built on — callers verify; ``ALA.refit`` does).  Counts
    are additive under the fixed-bin contract, so instead of
    re-histogramming every subset over every row this

      1. extends the existing subsets' masks/histograms by only the
         delta rows:  ``hist += masks(delta) @ onehot(delta)``  —
         O(S_old x n_delta);
      2. builds the new subsets' masks/histograms over the full rows —
         O(S_new x n);
      3. applies the trailing ``max_subsets`` window.

    Bin edges are *kept* from the original bank (that is what makes the
    update additive): delta rows outside the original training range
    clip into the reserved boundary bins and read as distant — exactly
    the drift signal the online engine watches.  The result is bit-equal
    to ``build_subset_bank`` on the concatenated data + merged log with
    ``inner_edges=bank.inner_edges``.
    """
    ii, oo, bb, thpt = (np.asarray(v, np.float64) for v in train)
    n = len(ii)
    n_old = n - int(n_delta)
    if n_old != bank.masks.shape[1]:
        raise ValueError(f"extend_bank: bank covers {bank.masks.shape[1]} "
                         f"rows but train has {n} with n_delta={n_delta}")
    cols = (ii, oo, bb, thpt)

    # 1. old subsets gain only the delta rows' mass
    if n_delta > 0:
        d_masks = batch_subset_masks(ii[n_old:], oo[n_old:], bb[n_old:],
                                     bank.subsets, universes)
        d_onehot = _onehot_bins(tuple(c[n_old:] for c in cols),
                                bank.inner_edges, bank.n_bins)
        hist_old = bank.hist + np.einsum("sn,fnb->sfb",
                                         d_masks.astype(np.float64),
                                         d_onehot)
        masks_old = np.concatenate([bank.masks, d_masks], axis=1)
    else:
        hist_old, masks_old = bank.hist.copy(), bank.masks

    # 2. new subsets over the full rows
    new_subsets = list(new_subsets)
    if new_subsets:
        n_masks = batch_subset_masks(ii, oo, bb, new_subsets, universes)
        onehot = _onehot_bins(cols, bank.inner_edges, bank.n_bins)
        hist_new = np.einsum("sn,fnb->sfb", n_masks.astype(np.float64),
                             onehot)
        hist = np.concatenate([hist_old, hist_new], axis=0)
        masks = np.concatenate([masks_old, n_masks], axis=0)
    else:
        hist, masks = hist_old, masks_old
    subsets = list(bank.subsets) + new_subsets

    # 3. trailing window — same cap semantics as build_subset_bank
    if max_subsets and len(subsets) > max_subsets:
        subsets = subsets[-max_subsets:]
        hist = hist[-max_subsets:]
        masks = masks[-max_subsets:]
    return _finalize_bank(bank.inner_edges, hist, masks, subsets,
                          universes, bank.n_bins)


def _pack_queries(queries: Sequence) -> Tuple[np.ndarray, np.ndarray]:
    """Ragged (ii, oo, bb, thpt) query tuples -> (Q, 4, L) float32 values
    + validity masks, L the longest query (non-finite values carry no
    mass)."""
    lens = [len(np.atleast_1d(q[0])) for q in queries]
    L = max(lens, default=1)
    vals = np.zeros((len(queries), len(FEATS), L), np.float32)
    valid = np.zeros((len(queries), len(FEATS), L), bool)
    for qi, q in enumerate(queries):
        for fi in range(len(FEATS)):
            col = np.atleast_1d(np.asarray(q[fi], np.float64))
            finite = np.isfinite(col)
            vals[qi, fi, :len(col)] = np.where(finite, col, 0.0)
            valid[qi, fi, :len(col)] = finite
    return vals, valid


def _distances_torch(vals, valid, inner_edges, s_unit, device):
    """(Q, F, L) query values + validity masks, (F, B-1) float32 edges and
    (S, F, B) unit subset histograms -> (Q, S) mean per-feature cosine
    distances, on ``device``: searchsorted -> scatter_add_ counts (whole
    numbers, exact in any order) -> L2-normalize -> one einsum."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    q_vals, q_valid, edges, unit_s = (put(a) for a in (vals, valid,
                                                       inner_edges, s_unit))
    Q, F, L = q_vals.shape
    B = unit_s.shape[-1]
    bins = torch.stack([torch.searchsorted(edges[f], q_vals[:, f, :]
                                           .contiguous(), right=True)
                        for f in range(F)], dim=1)            # (Q, F, L)
    flat = ((torch.arange(Q, device=device)[:, None, None] * F
             + torch.arange(F, device=device)[None, :, None]) * B + bins)
    counts = torch.zeros(Q * F * B, dtype=torch.float32, device=device)
    counts.scatter_add_(0, flat.reshape(-1), q_valid.float().reshape(-1))
    counts = counts.reshape(Q, F, B)
    nrm = torch.sqrt((counts * counts).sum(dim=-1, keepdim=True))
    unit = counts / torch.clamp(nrm, min=1e-30)
    sim = torch.einsum("qfb,sfb->qsf", unit, unit_s)
    return (1.0 - sim).mean(dim=-1)                           # (Q, S)


def bank_distances(bank: SubsetBank, queries: Sequence,
                   backend: str = "torch", device=None) -> np.ndarray:
    """Full (n_queries, n_subsets) cosine-distance matrix.

    ``backend="torch"`` computes it on ``device`` (None: the GPU) in one
    pass; ``backend="numpy"`` is the serial float64 reference (loops
    every (query, subset) pair) that the device path must match to
    <= 1e-6.  Invalid subsets (< MIN_SUBSET_ROWS rows) still get columns —
    mask with ``bank.valid`` before reducing (``bank_confidence`` does).
    """
    Q, S = len(queries), bank.n_subsets
    if Q == 0:
        return np.zeros((0, S))
    if backend == "torch":
        vals, valid = _pack_queries(queries)
        D = _distances_torch(vals, valid, bank.inner_edges, bank.unit,
                             resolve_device(device))
        return D.cpu().numpy().astype(np.float64)
    D = np.empty((Q, S), np.float64)
    for qi, q in enumerate(queries):
        qh = np.stack([_count_hist(np.atleast_1d(q[fi]), bank.inner_edges[fi],
                                   bank.n_bins)
                       for fi in range(len(FEATS))])           # (4, B)
        for si in range(S):
            D[qi, si] = np.mean([_cosine_distance(qh[fi], bank.hist[si, fi])
                                 for fi in range(len(FEATS))])
    return D


def bank_confidence(bank: SubsetBank, queries: Sequence,
                    backend: str = "torch", hw_dist=0.0, device=None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(d_min, confidence) vectors over queries; degenerate banks (no
    valid subset) yield the explicit (inf, 0.0) sentinel per query.

    ``hw_dist`` (scalar or per-query vector) is the hardware-descriptor
    distance of the queried hardware from the benchmarked hardware; the
    reported ``d_min`` stays the pure workload distance while the
    confidence squashes ``d_min + HW_DIST_WEIGHT * hw_dist``."""
    D = bank_distances(bank, queries, backend=backend, device=device)
    return dmin_confidence(D, bank.valid, hw_dist=hw_dist)


def dmin_confidence(D: np.ndarray, valid: np.ndarray, hw_dist=0.0
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Reduce a (Q, S) distance matrix over the valid subsets."""
    Q = D.shape[0]
    Dv = D[:, np.asarray(valid, bool)]
    if Dv.shape[1] == 0:
        d_min = np.full(Q, np.inf)
    else:
        d_min = Dv.min(axis=1)
    d_eff = d_min + HW_DIST_WEIGHT * np.asarray(hw_dist, np.float64)
    conf = np.where(np.isfinite(d_eff), 1.0 / (1.0 + d_eff), 0.0)
    return d_min, conf
