"""Low-overhead streaming metrics: counters, gauges, and mergeable
fixed-bin histograms.

A copy of the reference package's ``obs/metrics.py``, whole; the port
keeps its own because it imports nothing of the reference.  The serving
engines read ``percentile_with_inf``, ``tenant_rollup`` and ``RingLog``
from here.

The histogram shares the ``SubsetBank`` *fixed-bin contract*
(``core/uncertainty.py``): edges derive from a fixed [lo, hi] range
(geomspace for decade-spanning features, linspace otherwise), the two
boundary bins are reserved for out-of-range mass, and bin *assignment*
compares float32 values against float32 edges via
``searchsorted(side="right")`` — so a histogram built here buckets
exactly like the uncertainty bank does, and two shards built on the
same edges merge by plain addition.

Inf-mass convention (shared with ``percentile_with_inf``): shed /
never-served requests carry TTFT = +inf.  ``StreamHist`` keeps that
mass in explicit ``n_inf`` / ``n_neg_inf`` counters outside the finite
bins, and ``quantile`` returns the signed infinity whenever the
requested rank lands inside an inf mass.  NaN observations carry *no*
mass (tracked in ``n_nan`` for accounting, excluded from quantiles).
``quantile`` is the reference's as it stands: where exactly half the
mass is +inf its 50th percentile can be finite while
``percentile_with_inf`` says inf (an open question of the reference,
ROADMAP queue C).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, Optional, Sequence

import numpy as np

__all__ = [
    "percentile_with_inf", "fixed_edges", "bucketize", "StreamHist",
    "Counter", "Gauge", "RingLog", "tenant_rollup",
]


def percentile_with_inf(vals: np.ndarray, q: float) -> float:
    """Linear-interpolation percentile that tolerates an inf mass.

    ``np.percentile`` returns NaN when the quantile straddles infs
    (inf - inf inside its lerp); the correct answer there is inf, and on
    finite data this matches numpy exactly."""
    vals = np.asarray(vals, np.float64)
    if vals.size == 0:
        return float("inf")
    svals = np.sort(vals)
    pos = (len(svals) - 1) * q / 100.0
    lo = int(np.floor(pos))
    frac = pos - lo
    if frac == 0.0:
        return float(svals[lo])
    if not np.isfinite(svals[lo + 1]):
        return float("inf")
    return float(svals[lo] * (1.0 - frac) + svals[lo + 1] * frac)


def fixed_edges(lo: float, hi: float, n_bins: int,
                log: bool = False) -> np.ndarray:
    """(B-1,) float32 inner bucketize edges — the ``SubsetBank``
    contract for one feature.

    The [lo, hi] range splits into the B-2 core bins; the first inner
    edge sits at ``lo`` (``side="right"`` keeps v == lo in the core)
    and the last one ulp above ``hi``, so in-range values never occupy
    bins 0 / B-1 — those boundary bins are reserved for out-of-range
    mass, exactly like ``uncertainty._bank_edges``."""
    if n_bins < 3:
        raise ValueError(f"n_bins {n_bins} < 3 (need core + 2 boundary)")
    if log:
        lo = max(float(lo), 1e-9)
        hi = max(float(hi), lo * (1 + 1e-9))
        core = np.geomspace(lo, hi, n_bins - 1)[1:-1]
    else:
        lo = float(lo)
        hi = float(hi) if hi > lo else lo + 1.0
        core = np.linspace(lo, hi, n_bins - 1)[1:-1]
    lo32, hi32 = np.float32(lo), np.float32(hi)
    edges = np.concatenate(
        [[lo32], core.astype(np.float32),
         [np.nextafter(hi32, np.float32(np.inf))]])
    # float32 rounding of near-equal float64 edges must stay sorted
    return np.maximum.accumulate(edges)


def bucketize(vals: np.ndarray, inner_f32: np.ndarray) -> np.ndarray:
    """Fixed-bin assignment (float32 compare, out-of-range values clip
    into the boundary bins) — identical to the bank kernel's
    searchsorted."""
    return np.searchsorted(inner_f32, np.asarray(vals, np.float32),
                           side="right").astype(np.int32)


@dataclasses.dataclass
class StreamHist:
    """Mergeable fixed-bin histogram with explicit inf/NaN mass.

    Build once from a fixed range (``from_range``) or from a sample
    (``from_values``), feed it value batches with ``observe``, merge
    shards built on the same edges with ``merge`` — counts add, so
    merge order never matters and shard-merge quantiles equal the
    whole-stream quantiles exactly.  ``quantile`` is accurate to one
    bin width on finite mass and honors the inf-mass convention."""
    inner_edges: np.ndarray               # (B-1,) float32
    counts: np.ndarray                    # (B,) float64 finite mass
    n_inf: float = 0.0                    # +inf mass (the miss mass)
    n_neg_inf: float = 0.0
    n_nan: float = 0.0                    # tracked, never mass

    @classmethod
    def from_range(cls, lo: float, hi: float, n_bins: int = 48,
                   log: bool = False) -> "StreamHist":
        return cls(inner_edges=fixed_edges(lo, hi, n_bins, log=log),
                   counts=np.zeros(n_bins, np.float64))

    @classmethod
    def from_values(cls, vals: np.ndarray, n_bins: int = 48,
                    log: bool = False) -> "StreamHist":
        """Edges from the finite value range, then observe everything
        (inf/NaN land in their explicit masses)."""
        vals = np.asarray(vals, np.float64)
        fin = vals[np.isfinite(vals)]
        lo = float(fin.min()) if len(fin) else 0.0
        hi = float(fin.max()) if len(fin) else 1.0
        h = cls.from_range(lo, hi, n_bins, log=log)
        h.observe(vals)
        return h

    @property
    def n_bins(self) -> int:
        return len(self.counts)

    @property
    def total(self) -> float:
        """Total observed mass (finite + inf; NaN excluded)."""
        return float(self.counts.sum() + self.n_inf + self.n_neg_inf)

    def observe(self, vals: np.ndarray,
                weights: Optional[np.ndarray] = None) -> "StreamHist":
        vals = np.atleast_1d(np.asarray(vals, np.float64))
        w = np.ones(len(vals)) if weights is None \
            else np.asarray(weights, np.float64)
        nan = np.isnan(vals)
        pos = np.isposinf(vals)
        neg = np.isneginf(vals)
        self.n_nan += float(w[nan].sum())
        self.n_inf += float(w[pos].sum())
        self.n_neg_inf += float(w[neg].sum())
        fin = ~(nan | pos | neg)
        if fin.any():
            bins = bucketize(vals[fin], self.inner_edges)
            self.counts += np.bincount(bins, w[fin],
                                       minlength=self.n_bins)
        return self

    def merge(self, other: "StreamHist") -> "StreamHist":
        """Accumulate another shard in place (edges must match)."""
        if not np.array_equal(self.inner_edges, other.inner_edges):
            raise ValueError("cannot merge histograms with different edges")
        self.counts = self.counts + other.counts
        self.n_inf += other.n_inf
        self.n_neg_inf += other.n_neg_inf
        self.n_nan += other.n_nan
        return self

    def copy(self) -> "StreamHist":
        return StreamHist(inner_edges=self.inner_edges,
                          counts=self.counts.copy(), n_inf=self.n_inf,
                          n_neg_inf=self.n_neg_inf, n_nan=self.n_nan)

    @classmethod
    def merged(cls, hists: Iterable["StreamHist"]) -> "StreamHist":
        out = None
        for h in hists:
            out = h.copy() if out is None else out.merge(h)
        if out is None:
            raise ValueError("nothing to merge")
        return out

    def quantile(self, q: float) -> float:
        """q-th percentile of the observed mass.

        Mass ordering: [-inf][finite bins, interpolated][+inf].  A rank
        inside an inf mass returns that signed infinity — the same miss
        convention as ``percentile_with_inf``.  Finite answers are
        linear within the bin (boundary bins collapse to their single
        known edge), so the error vs the exact percentile is at most
        one bin width for in-range data."""
        tot = self.total
        if tot <= 0:
            return float("inf")
        target = q / 100.0 * tot
        if self.n_neg_inf > 0 and target <= self.n_neg_inf:
            return float("-inf")
        cum = self.n_neg_inf + np.cumsum(self.counts)
        i = int(np.searchsorted(cum, target, side="left"))
        if i >= self.n_bins or self.counts[i:].sum() <= 0:
            return float("inf")
        e = self.inner_edges.astype(np.float64)
        if i == 0:                         # below-range boundary bin
            return float(e[0])
        if i == self.n_bins - 1:           # above-range boundary bin
            return float(e[-1])
        lo_e, hi_e = float(e[i - 1]), float(e[i])
        prev = float(cum[i - 1]) if i else self.n_neg_inf
        frac = (target - prev) / max(float(cum[i]) - prev, 1e-300)
        return lo_e + frac * (hi_e - lo_e)

    def to_dict(self) -> Dict[str, object]:
        return {"edges": self.inner_edges.astype(float).tolist(),
                "counts": self.counts.tolist(), "n_inf": self.n_inf,
                "n_neg_inf": self.n_neg_inf, "n_nan": self.n_nan}


@dataclasses.dataclass
class Counter:
    """Streaming monotone counter; merges by addition."""
    value: float = 0.0

    def inc(self, k: float = 1.0) -> None:
        self.value += k

    def merge(self, other: "Counter") -> "Counter":
        self.value += other.value
        return self


@dataclasses.dataclass
class Gauge:
    """Streaming summary of a sampled series (no raw retention)."""
    n: int = 0
    sum: float = 0.0
    min: float = float("inf")
    max: float = float("-inf")
    last: float = float("nan")

    def set(self, v: float) -> None:
        v = float(v)
        self.n += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        self.last = v

    @property
    def mean(self) -> float:
        return self.sum / self.n if self.n else float("nan")

    def merge(self, other: "Gauge") -> "Gauge":
        if other.n:
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)
            self.sum += other.sum
            self.n += other.n
            self.last = other.last
        return self


class RingLog(Sequence):
    """Bounded append-only log: keeps the most recent ``cap`` entries
    while counting everything — ``n_total`` stays lossless even when
    samples are dropped, so 10M-request runs can't grow telemetry
    unboundedly but accounting still adds up.  Duck-types as a list for
    the common consumers (append / len / iterate / index)."""

    def __init__(self, cap: int, init: Iterable = ()):
        if cap < 1:
            raise ValueError(f"RingLog cap {cap} < 1")
        self.cap = int(cap)
        init = list(init)
        self._dq: collections.deque = collections.deque(init,
                                                        maxlen=self.cap)
        self.n_total = len(init)

    def append(self, item) -> None:
        self._dq.append(item)
        self.n_total += 1

    def extend(self, items: Iterable) -> None:
        for it in items:
            self.append(it)

    def clear(self) -> None:
        # drops the retained window; total stays lossless
        self._dq.clear()

    @property
    def n_dropped(self) -> int:
        return self.n_total - len(self._dq)

    def __len__(self) -> int:
        return len(self._dq)

    def __iter__(self):
        return iter(self._dq)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._dq)[i]
        return self._dq[i]

    def __repr__(self) -> str:
        return (f"RingLog(cap={self.cap}, kept={len(self._dq)}, "
                f"total={self.n_total})")


def tenant_rollup(tenant: np.ndarray, ttft_vals: np.ndarray,
                  oo: np.ndarray, completed: np.ndarray,
                  shed: np.ndarray, retries: np.ndarray,
                  slo_map: Optional[Dict[str, float]] = None
                  ) -> Dict[str, Dict[str, float]]:
    """Per-tenant request accounting, TTFT tail and SLO attainment —
    the single rollup behind ``SimResult.per_tenant`` in both serving
    engines.

    ``ttft_vals`` follows the shared miss convention (inf for shed /
    no-first-token requests); tenants absent from ``slo_map`` get
    ``attainment = nan``; ``goodput_share`` is the tenant's fraction of
    completed output tokens."""
    tenant = np.asarray(tenant, dtype=object)
    ttft_vals = np.asarray(ttft_vals, np.float64)
    oo = np.asarray(oo, np.int64)
    completed = np.asarray(completed, bool)
    shed = np.asarray(shed, bool)
    retries = np.asarray(retries, np.int64)
    total_tok = int(oo[completed].sum())
    out: Dict[str, Dict[str, float]] = {}
    for name in sorted(set(tenant.tolist())):
        m = tenant == name
        v = ttft_vals[m]
        slo = slo_map.get(name) if slo_map else None
        tok = int(oo[m & completed].sum())
        out[name] = {
            "n_requests": int(m.sum()),
            "n_completed": int((m & completed).sum()),
            "n_shed": int(shed[m].sum()),
            "n_retries": int(retries[m].sum()),
            "ttft_slo_s": float(slo) if slo is not None else float("nan"),
            "attainment": (float(np.mean(v <= slo)) if slo is not None
                           else float("nan")),
            "ttft_p50_s": percentile_with_inf(v, 50.0),
            "ttft_p95_s": percentile_with_inf(v, 95.0),
            "ttft_p99_s": percentile_with_inf(v, 99.0),
            "goodput_share": tok / total_tok if total_tok else 0.0,
        }
    return out
