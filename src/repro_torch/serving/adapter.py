"""Simulated-trace results -> ``core.dataset.Dataset`` rows.

Dynamic-trace scenarios feed the same registry / ALA fit path as the
static grids: chop a ``SimResult`` into fixed windows, keep the
steady-state ones (at least ``min_completions`` finished requests and
some decode work), and summarize each into one benchmark row:

  * ``ii, oo`` — power-of-two bucketed means over the window's completed
    requests (the same bucketing ``BatchingQueue`` uses, so heterogeneous
    shapes collapse into a fittable grid);
  * ``bb``     — duration-weighted mean decode batch size;
  * ``thpt``   — output tokens per *busy* second across the window's
    steps, the per-replica saturated-throughput analog of the static
    harness measurement.

``windows_to_dataset`` stamps the registry key columns (model, acc,
acc_count, back, prec, mode) so rows from a trace run sit beside — and
group separately from — static-grid rows in one ``Dataset``.

A copy of the reference package's ``serving/adapter.py``: the same
result gives the reference's windows and rows bit for bit.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List

import numpy as np

from repro_torch.core.dataset import Dataset
from repro_torch.inference.scheduler import BatchingQueue
from repro_torch.perfmodel.simulator import ServingSetup
from repro_torch.serving.simulator import SimResult

TRACE_BACKEND = "sim-trace"


@dataclasses.dataclass
class WindowSummary:
    t0: float
    t1: float
    ii: int                    # bucketed mean prompt length
    oo: int                    # bucketed mean output length
    bb: float                  # duration-weighted mean decode batch
    thpt: float                # output tokens / busy second
    n_completions: int


def _window_overlaps(t0: float, t1: float, window_s: float, n_win: int):
    """Yield (window index, overlap fraction) for the span [t0, t1].

    Fractions sum to 1.0; a zero-duration span credits the window
    containing ``t1`` entirely."""
    if t1 <= t0:
        yield min(max(int(t1 / window_s), 0), n_win - 1), 1.0
        return
    w0 = min(max(int(t0 / window_s), 0), n_win - 1)
    w1 = min(max(int(np.ceil(t1 / window_s)) - 1, 0), n_win - 1)
    dur = t1 - t0
    for w in range(w0, w1 + 1):
        ov = min(t1, (w + 1) * window_s) - max(t0, w * window_s)
        # clipped boundary windows absorb any out-of-range span
        if w == w0:
            ov += max(w0 * window_s - t0, 0.0)
        if w == w1:
            ov += max(t1 - (w1 + 1) * window_s, 0.0)
        yield w, ov / dur


def _accumulate_slow(result: SimResult, window_s: float, n_win: int):
    """Reference per-step accumulation over ``result.steps`` records."""
    busy = np.zeros(n_win)
    toks = np.zeros(n_win)
    dec_t = np.zeros(n_win)
    bb_wt = np.zeros(n_win)
    for s in result.steps:
        for w, frac in _window_overlaps(s.t_end - s.duration_s, s.t_end,
                                        window_s, n_win):
            d = frac * s.duration_s
            busy[w] += d
            toks[w] += frac * s.tokens_out
            if s.kind == "decode":
                dec_t[w] += d
                bb_wt[w] += s.bb * d
    n_comp = np.zeros(n_win, np.int64)
    ii_sum = np.zeros(n_win)
    oo_sum = np.zeros(n_win)
    for r in result.completed:
        w = min(int(r.done_s / window_s), n_win - 1)
        n_comp[w] += 1
        ii_sum[w] += r.ii
        oo_sum[w] += r.oo
    return busy, toks, dec_t, bb_wt, n_comp, ii_sum, oo_sum


def _accumulate_fast(result, window_s: float, n_win: int):
    """Array accumulation over a ``FleetSimResult``'s raw columns —
    identical window semantics to ``_accumulate_slow`` (steps spanning
    more than one window fall back to the per-step overlap split; they
    are a ``duration / window_s`` fraction of the stream)."""
    a = result.step_arrays
    t1 = a["t_end"]
    d = a["duration_s"]
    tok = a["tokens_out"].astype(np.float64)
    dec = a["kind"] == 1
    t0 = t1 - d
    w0 = np.clip(np.floor(t0 / window_s).astype(np.int64), 0, n_win - 1)
    w1 = np.clip(np.ceil(t1 / window_s).astype(np.int64) - 1, 0,
                 n_win - 1)
    busy = np.zeros(n_win)
    toks = np.zeros(n_win)
    dec_t = np.zeros(n_win)
    bb_wt = np.zeros(n_win)
    zero = d <= 0
    if zero.any():                        # zero-duration span: window of t1
        wz = np.clip((t1[zero] / window_s).astype(np.int64), 0, n_win - 1)
        np.add.at(toks, wz, tok[zero])
    one = ~zero & (w1 <= w0)              # span inside a single window
    np.add.at(busy, w0[one], d[one])
    np.add.at(toks, w0[one], tok[one])
    oned = one & dec
    np.add.at(dec_t, w0[oned], d[oned])
    np.add.at(bb_wt, w0[oned], a["bb"][oned] * d[oned])
    multi = ~zero & (w1 > w0)             # boundary straddlers: exact split
    for i in np.flatnonzero(multi):
        for w, frac in _window_overlaps(float(t0[i]), float(t1[i]),
                                        window_s, n_win):
            dd = frac * float(d[i])
            busy[w] += dd
            toks[w] += frac * float(tok[i])
            if dec[i]:
                dec_t[w] += dd
                bb_wt[w] += float(a["bb"][i]) * dd
    q = result.req
    comp = np.isfinite(q["done_s"])
    wc = np.minimum((q["done_s"][comp] / window_s).astype(np.int64),
                    n_win - 1)
    n_comp = np.bincount(wc, minlength=n_win)
    ii_sum = np.bincount(wc, weights=q["ii"][comp].astype(np.float64),
                         minlength=n_win)
    oo_sum = np.bincount(wc, weights=q["oo"][comp].astype(np.float64),
                         minlength=n_win)
    return busy, toks, dec_t, bb_wt, n_comp, ii_sum, oo_sum


def summarize_windows(result: SimResult, window_s: float = 5.0,
                      min_completions: int = 2) -> List[WindowSummary]:
    if window_s <= 0:
        raise ValueError("window_s must be positive")
    horizon = result.sim_end_s
    if horizon <= 0:
        # degenerate run (ended at t=0): every window would have zero
        # duration — emitting them poisons downstream rate math
        return []
    n_win = max(int(np.ceil(horizon / window_s)), 1)
    # a step spanning a window boundary splits by overlap fraction —
    # crediting it entirely to the window holding t_end would bias both
    # per-window busy time and thpt (tokens / busy second)
    if getattr(result, "step_arrays", None) is not None \
            and getattr(result, "req", None) is not None:
        acc = _accumulate_fast(result, window_s, n_win)
    else:
        acc = _accumulate_slow(result, window_s, n_win)
    busy, toks, dec_t, bb_wt, n_comp, ii_sum, oo_sum = acc
    out: List[WindowSummary] = []
    for w in range(n_win):
        nc = int(n_comp[w])
        if nc < min_completions or dec_t[w] <= 0:
            continue
        if busy[w] <= 0 or toks[w] <= 0:
            continue
        t0, t1 = w * window_s, min((w + 1) * window_s, horizon)
        if t1 <= t0:                      # zero-duration clipped window
            continue
        bb = bb_wt[w] / max(dec_t[w], 1e-12)
        bii, boo = BatchingQueue.bucket(ii_sum[w] / nc, oo_sum[w] / nc)
        out.append(WindowSummary(
            t0=t0, t1=t1, ii=bii, oo=boo,
            bb=float(bb), thpt=float(toks[w] / busy[w]),
            n_completions=nc))
    return out


def windows_to_rows(windows: List[WindowSummary], setup: ServingSetup,
                    model: str, back: str = TRACE_BACKEND,
                    prec: str = "bf16", mode: str = "serve"
                    ) -> List[Dict]:
    """One benchmark row per window, keyed and *featurized* by hardware:
    besides the ``acc`` identity column the row carries the
    ``hw_*`` descriptor features (log10 delivered rooflines) so a
    hardware-conditioned model can regress across accelerators."""
    from repro_torch.perfmodel.hardware import feature_row
    hw_cols = feature_row(setup.hw)
    return [dict(model=model, acc=setup.hw.name, acc_count=setup.chips,
                 back=back, prec=prec, mode=mode,
                 ii=w.ii, oo=w.oo, bb=max(int(round(w.bb)), 1),
                 thpt=float(w.thpt), **hw_cols)
            for w in windows]


def _finite_row(row: Dict) -> bool:
    return all(np.isfinite(float(row[k])) for k in ("ii", "oo", "bb",
                                                    "thpt"))


def windows_to_dataset(result: SimResult, setup: ServingSetup, model: str,
                       window_s: float = 5.0, min_completions: int = 2,
                       back: str = TRACE_BACKEND,
                       on_nonfinite: str = "drop") -> Dataset:
    """Steady-state windows of one simulated run as a registry dataset.

    Raises ``ValueError`` when no window reaches steady state — callers
    should lengthen the trace or shrink ``window_s`` rather than feed an
    empty dataset into a fit.  Non-finite window rows (a degenerate or
    fault-corrupted measurement) are dropped with a warning reporting
    the count (``on_nonfinite="drop"``) or raise
    (``on_nonfinite="raise"``); they never reach the fit silently.

    Heterogeneous fleets are *rejected*: a run whose replicas span more
    than one hardware profile cannot be summarized under one ``acc``
    key — windows mix steps served at different rooflines, and stamping
    them all with ``setup``'s hardware would silently corrupt the
    database.  Use ``windows_to_datasets_by_hardware`` instead.  A
    single-hardware run whose hardware disagrees with ``setup.hw`` is
    rejected for the same reason."""
    hw_names = set(getattr(result, "replica_hw", {}).values())
    if len(hw_names) > 1:
        raise ValueError(
            f"heterogeneous fleet ({sorted(hw_names)}): rows cannot share "
            f"one 'acc' key; use windows_to_datasets_by_hardware")
    if hw_names and setup.hw.name not in hw_names:
        raise ValueError(
            f"result ran on {sorted(hw_names)[0]!r} but setup names "
            f"{setup.hw.name!r}; rows would be keyed to the wrong hardware")
    rows = windows_to_rows(
        summarize_windows(result, window_s, min_completions),
        setup, model, back=back)
    n_bad = sum(1 for r in rows if not _finite_row(r))
    if n_bad:
        if on_nonfinite == "raise":
            raise ValueError(f"windows_to_dataset: {n_bad} non-finite "
                             f"window row(s)")
        warnings.warn(f"windows_to_dataset: dropped {n_bad} non-finite "
                      f"window row(s)", RuntimeWarning, stacklevel=2)
        rows = [r for r in rows if _finite_row(r)]
    if not rows:
        raise ValueError("no steady-state windows in this run; "
                         "lengthen the trace or shrink window_s")
    return Dataset.from_rows(rows)


class _HardwareView:
    """A per-hardware slice of a SimResult: only the steps / requests
    served by the given replica ids.  Quacks just enough like a
    ``SimResult`` (or ``FleetSimResult``) for ``summarize_windows``."""

    def __init__(self, result: SimResult, rids: List[int]):
        self.sim_end_s = result.sim_end_s
        self.replica_hw = {r: h for r, h in result.replica_hw.items()
                           if r in rids}
        rid_set = set(rids)
        sa = getattr(result, "step_arrays", None)
        if sa is not None and getattr(result, "req", None) is not None:
            sm = np.isin(sa["replica"], list(rid_set))
            self.step_arrays = {k: v[sm] for k, v in sa.items()}
            qm = np.isin(result.req["replica"], list(rid_set))
            self.req = {k: v[qm] for k, v in result.req.items()}
        else:
            self.step_arrays = None
            self.req = None
            self.steps = [s for s in result.steps if s.replica in rid_set]
            self.completed = [r for r in result.completed
                              if r.replica in rid_set]


def windows_to_datasets_by_hardware(
        result: SimResult, setups: Dict[str, ServingSetup], model: str,
        window_s: float = 5.0, min_completions: int = 2,
        back: str = TRACE_BACKEND, on_nonfinite: str = "drop"
        ) -> Dict[str, Dataset]:
    """Heterogeneous-fleet run -> one dataset per hardware profile.

    ``setups`` maps each hardware name in ``result.replica_hw`` to the
    ServingSetup its replicas ran (``SimConfig.setup_for`` resolves
    them).  Steps and completions are attributed to hardware through
    their replica id, so every row is keyed — and featurized — by the
    accelerator that actually served it.  Hardware whose windows never
    reach steady state is skipped with a warning (a lightly loaded tier
    is data-starved, not an error)."""
    groups: Dict[str, List[int]] = {}
    for rid, hw in sorted(result.replica_hw.items()):
        groups.setdefault(hw, []).append(rid)
    if not groups:
        raise ValueError("result carries no replica_hw attribution")
    out: Dict[str, Dataset] = {}
    for hw, rids in sorted(groups.items()):
        if hw not in setups:
            raise KeyError(f"no ServingSetup supplied for hardware {hw!r}")
        view = _HardwareView(result, rids)
        try:
            out[hw] = windows_to_dataset(
                view, setups[hw], model, window_s=window_s,
                min_completions=min_completions, back=back,
                on_nonfinite=on_nonfinite)
        except ValueError as e:
            if "steady-state" not in str(e):
                raise
            warnings.warn(f"hardware {hw!r}: {e}; skipped",
                          RuntimeWarning, stacklevel=2)
    if not out:
        raise ValueError("no hardware tier produced steady-state windows")
    return out
