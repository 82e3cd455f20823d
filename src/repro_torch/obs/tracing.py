"""Per-request span tracing as vectorized column buffers.

Spans cover the full request lifecycle the engines model —
arrival → admission/first token (prefill) → decode → completion, or
shed (with reason) and crash-driven retries — plus replica crash /
restore annotations carried alongside from the fault log.  Rather than
instrumenting the engines' hot loops, spans are *derived post-run*
from the columns both engines already record (the fleet engine's
``req`` arrays directly; the heap engine's ``RequestRecord`` objects
via one bulk pass), so the vectorized engine keeps its events/s: the
<5% overhead gate at ``sample_rate=1.0`` is enforced on the card's host
by ``chip_smoke.py``'s observability phase, as the reference's
``benchmarks/run.py obs_engine`` enforces it.

Sampling is a deterministic hash of the request id (no RNG state), so
the same requests are kept regardless of engine, shard order, or
sample timing — heap and fleet runs over one seeded trace yield
byte-identical span populations.  The hash stays in numpy ``uint64``
(wrap-around multiplies, logical shifts): a torch ``int64`` copy would
shift the sign bit in.

A copy of the reference package's ``obs/tracing.py``: on the same
result it gives the reference's span table, statistics, histograms and
queue depth bit for bit (``tests/test_torch_obs_tracing.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.obs.metrics import StreamHist, percentile_with_inf

__all__ = ["ObsConfig", "SpanTable", "record_spans", "span_stats",
           "span_hists", "queue_depth_series"]


@dataclasses.dataclass
class ObsConfig:
    """Observability hook carried on ``SimConfig.obs`` (and accepted by
    ``ALAAutoscaler`` / ``OnlineALA``).  Everything defaults to "on,
    unbounded" except the ring caps, which default to None (current
    behavior: keep everything)."""
    enabled: bool = True
    sample_rate: float = 1.0          # request-span keep fraction
    sample_seed: int = 0              # perturbs the rid keep-hash
    max_steps: Optional[int] = None   # ring cap on retained step records
    max_fault_events: Optional[int] = None   # ring cap on fault_log
    max_cal_events: Optional[int] = None     # ring cap on audit events
    max_log_entries: Optional[int] = None    # autoscaler decision logs
    hist_bins: int = 48               # StreamHist bins for span_hists
    ape_ok_pct: float = 25.0          # calibration: tick "accurate" iff
    reliability_bins: int = 10        # APE <= ape_ok_pct, binned conf


def _keep_mask(rid: np.ndarray, rate: float, seed: int) -> np.ndarray:
    """Deterministic per-rid sampling — order / engine independent."""
    if rate >= 1.0:
        return np.ones(len(rid), bool)
    if rate <= 0.0:
        return np.zeros(len(rid), bool)
    with np.errstate(over="ignore"):          # wrap-around is the hash
        h = rid.astype(np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    h ^= np.uint64((seed * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF)
    h ^= h >> np.uint64(31)
    h *= np.uint64(0x94D049BB133111EB)
    h ^= h >> np.uint64(29)
    return (h >> np.uint64(11)).astype(np.float64) / 2.0 ** 53 < rate


@dataclasses.dataclass
class SpanTable:
    """Column-oriented request spans.  All times are absolute sim
    seconds; missing phase boundaries are NaN (a shed request has NaN
    ``first_token_s`` / ``done_s`` and a finite ``shed_s``)."""
    rid: np.ndarray                   # (n,) int64
    tenant: np.ndarray                # (n,) object (str)
    replica: np.ndarray               # (n,) int32; -1 = never placed
    ii: np.ndarray                    # (n,) int64 input tokens
    oo: np.ndarray                    # (n,) int64 output tokens
    arrival_s: np.ndarray             # (n,) float64
    first_token_s: np.ndarray         # (n,) float64; NaN = no first token
    done_s: np.ndarray                # (n,) float64; NaN = not completed
    shed_s: np.ndarray                # (n,) float64; NaN = not shed
    retries: np.ndarray               # (n,) int64 crash requeues
    shed: np.ndarray                  # (n,) bool
    shed_reason: np.ndarray           # (n,) object (str; "" = served)
    sample_rate: float = 1.0
    n_source: int = 0                 # pre-sampling request count

    @property
    def n(self) -> int:
        return len(self.rid)

    # derived phases -- inf marks the miss mass (shared convention)
    def ttft_s(self) -> np.ndarray:
        v = self.first_token_s - self.arrival_s
        miss = self.shed | ~np.isfinite(self.first_token_s)
        return np.where(miss, np.inf, v)

    def e2e_s(self) -> np.ndarray:
        v = self.done_s - self.arrival_s
        return np.where(np.isfinite(self.done_s), v, np.inf)

    def decode_s(self) -> np.ndarray:
        """first-token -> completion wall time (the decode phase)."""
        v = self.done_s - self.first_token_s
        ok = np.isfinite(self.done_s) & np.isfinite(self.first_token_s)
        return np.where(ok, v, np.inf)

    def tpot_s(self) -> np.ndarray:
        """Decode seconds per output token past the first."""
        dec = self.decode_s()
        steps = np.maximum(self.oo - 1, 1)
        return np.where(np.isfinite(dec), dec / steps, np.inf)

    def select(self, mask: np.ndarray) -> "SpanTable":
        return SpanTable(
            rid=self.rid[mask], tenant=self.tenant[mask],
            replica=self.replica[mask], ii=self.ii[mask],
            oo=self.oo[mask], arrival_s=self.arrival_s[mask],
            first_token_s=self.first_token_s[mask],
            done_s=self.done_s[mask], shed_s=self.shed_s[mask],
            retries=self.retries[mask], shed=self.shed[mask],
            shed_reason=self.shed_reason[mask],
            sample_rate=self.sample_rate, n_source=self.n_source)


def record_spans(result, obs: Optional[ObsConfig] = None) -> SpanTable:
    """Build the span table from a finished ``SimResult``.

    Fleet results expose the columns directly (``result.req`` — zero
    copies beyond the sampling gather); heap results are converted in
    one bulk pass over ``records``."""
    rate = float(getattr(obs, "sample_rate", 1.0)) if obs else 1.0
    seed = int(getattr(obs, "sample_seed", 0)) if obs else 0
    req = getattr(result, "req", None)
    if req is not None:                       # fleet: vectorized path
        from repro_torch.serving.fleet import _SHED_NAMES
        n = len(req["rid"])
        reasons = np.asarray(_SHED_NAMES, object)[
            np.asarray(req["shed_reason"], np.int64)]
        t = SpanTable(
            rid=np.asarray(req["rid"], np.int64),
            tenant=np.asarray(req["tenant"], object),
            replica=np.asarray(req["replica"], np.int32),
            ii=np.asarray(req["ii"], np.int64),
            oo=np.asarray(req["oo"], np.int64),
            arrival_s=np.asarray(req["arrival_s"], np.float64),
            first_token_s=np.asarray(req["first_token_s"], np.float64),
            done_s=np.asarray(req["done_s"], np.float64),
            shed_s=np.asarray(req["shed_s"], np.float64),
            retries=np.asarray(req["retries"], np.int64),
            shed=np.asarray(req["shed"], bool),
            shed_reason=reasons, sample_rate=rate, n_source=n)
    else:                                     # heap: one bulk pass
        recs = result.records
        n = len(recs)

        def col(get, dtype, missing=np.nan):
            out = np.empty(n, dtype)
            for i, r in enumerate(recs):
                v = get(r)
                out[i] = missing if v is None else v
            return out

        t = SpanTable(
            rid=col(lambda r: r.rid, np.int64, 0),
            tenant=np.array([r.tenant for r in recs], object),
            replica=col(lambda r: r.replica, np.int32, -1),
            ii=col(lambda r: r.ii, np.int64, 0),
            oo=col(lambda r: r.oo, np.int64, 0),
            arrival_s=col(lambda r: r.arrival_s, np.float64),
            first_token_s=col(lambda r: r.first_token_s, np.float64),
            done_s=col(lambda r: r.done_s, np.float64),
            shed_s=col(lambda r: r.shed_s, np.float64),
            retries=col(lambda r: r.retries, np.int64, 0),
            shed=col(lambda r: r.shed, bool, False),
            shed_reason=np.array([r.shed_reason for r in recs], object),
            sample_rate=rate, n_source=n)
    if rate < 1.0:
        t = t.select(_keep_mask(t.rid, rate, seed))
        t.sample_rate = rate
        t.n_source = n
    return t


def span_stats(table: SpanTable) -> Dict[str, float]:
    """Engine-comparable span statistics — the parity surface checked
    between heap and fleet runs of one seeded trace."""
    ttft = table.ttft_s()
    e2e = table.e2e_s()
    tpot = table.tpot_s()
    reasons: Dict[str, int] = {}
    for r in table.shed_reason[table.shed]:
        reasons[str(r)] = reasons.get(str(r), 0) + 1
    return {
        "n_spans": int(table.n),
        "n_source": int(table.n_source),
        "n_completed": int(np.isfinite(table.done_s).sum()),
        "n_shed": int(table.shed.sum()),
        "n_retries": int(table.retries.sum()),
        "shed_by_reason": reasons,
        "out_tokens": int(table.oo[np.isfinite(table.done_s)].sum()),
        "ttft_p50_s": percentile_with_inf(ttft, 50.0),
        "ttft_p95_s": percentile_with_inf(ttft, 95.0),
        "e2e_p50_s": percentile_with_inf(e2e, 50.0),
        "e2e_p95_s": percentile_with_inf(e2e, 95.0),
        "tpot_p50_s": percentile_with_inf(tpot, 50.0),
    }


def span_hists(table: SpanTable, n_bins: int = 48,
               by: Optional[np.ndarray] = None
               ) -> Dict[str, "StreamHist"]:
    """TTFT / TPOT / e2e histograms for the table (or, with ``by`` set
    to a per-span key array, mergeable per-group shards: callers merge
    group hists and read fleet-wide percentiles without raw values)."""
    ttft = table.ttft_s()
    fin = ttft[np.isfinite(ttft)]
    lo = float(fin.min()) if len(fin) else 0.0
    hi = float(fin.max()) if len(fin) else 1.0

    def build(vals):
        h = StreamHist.from_range(lo, hi, n_bins)
        h.observe(vals)
        return h

    if by is None:
        return {"ttft_s": build(ttft),
                "tpot_s": StreamHist.from_values(table.tpot_s(), n_bins),
                "e2e_s": StreamHist.from_values(table.e2e_s(), n_bins)}
    by = np.asarray(by, object)
    return {str(k): build(ttft[by == k]) for k in sorted(set(by.tolist()))}


def queue_depth_series(table: SpanTable, bucket_s: float = 1.0,
                       t_end: Optional[float] = None
                       ) -> Dict[str, np.ndarray]:
    """Queue depth (arrived, not yet started or shed) sampled on a
    regular grid — vectorized from span boundaries, feeds a StreamHist
    for queue-depth percentiles."""
    if table.n == 0:
        return {"t_s": np.zeros(0), "depth": np.zeros(0, np.int64)}
    start = np.where(np.isfinite(table.first_token_s),
                     table.first_token_s, np.inf)
    leave = np.minimum(start, np.where(np.isfinite(table.shed_s),
                                       table.shed_s, np.inf))
    t0 = float(table.arrival_s.min())
    t1 = float(t_end) if t_end is not None else \
        float(leave[np.isfinite(leave)].max()) if np.isfinite(leave).any() \
        else float(table.arrival_s.max())
    grid = np.arange(t0, t1 + bucket_s, bucket_s)
    arr = np.sort(table.arrival_s)
    lv = np.sort(leave[np.isfinite(leave)])
    depth = (np.searchsorted(arr, grid, side="right")
             - np.searchsorted(lv, grid, side="right"))
    return {"t_s": grid, "depth": depth.astype(np.int64)}
