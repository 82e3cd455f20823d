"""Telemetry export: JSONL events, Chrome trace-event timelines
(Perfetto-loadable), and the markdown scorecard.

The Chrome trace uses the legacy JSON trace-event format that both
``chrome://tracing`` and https://ui.perfetto.dev load directly:
replica step slices are complete ("X") events on the *replicas*
process, sampled request spans are async begin/end ("b"/"e") pairs on
per-tenant tracks, and faults / control decisions are instant ("i")
events.  Timestamps are microseconds of sim time.

A copy of the reference package's ``obs/export.py``: the same result
gives the reference's trace dict, JSONL bytes and scorecard
(``tests/test_torch_obs_export.py``).
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["write_jsonl", "spans_to_dicts", "chrome_trace",
           "write_chrome_trace", "scorecard_markdown"]

_US = 1e6


def _jsonable(v):
    if isinstance(v, (np.floating, np.integer)):
        return v.item()
    if isinstance(v, float) and not np.isfinite(v):
        return str(v)                 # "inf"/"nan" — JSONL stays valid
    return v


def write_jsonl(records: Iterable, path) -> int:
    """One JSON object per line.  Accepts dicts or objects with a
    ``to_dict`` (e.g. ``CalEvent``); returns the line count."""
    path = pathlib.Path(path)
    n = 0
    with path.open("w") as f:
        for rec in records:
            d = rec.to_dict() if hasattr(rec, "to_dict") else dict(rec)
            f.write(json.dumps({k: _jsonable(v) for k, v in d.items()})
                    + "\n")
            n += 1
    return n


def spans_to_dicts(table) -> List[Dict[str, object]]:
    """SpanTable rows as JSONL-ready dicts (NaN boundaries omitted)."""
    out = []
    for i in range(table.n):
        d = {"rid": int(table.rid[i]), "tenant": str(table.tenant[i]),
             "replica": int(table.replica[i]), "ii": int(table.ii[i]),
             "oo": int(table.oo[i]),
             "arrival_s": float(table.arrival_s[i]),
             "retries": int(table.retries[i]),
             "shed": bool(table.shed[i])}
        for k in ("first_token_s", "done_s", "shed_s"):
            v = float(getattr(table, k)[i])
            if np.isfinite(v):
                d[k] = v
        if table.shed[i]:
            d["shed_reason"] = str(table.shed_reason[i])
        out.append(d)
    return out


def _meta(pid: int, name: str, tid: Optional[int] = None,
          tname: Optional[str] = None) -> List[dict]:
    evs = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name}}]
    if tid is not None:
        evs.append({"name": "thread_name", "ph": "M", "pid": pid,
                    "tid": tid, "args": {"name": tname or f"t{tid}"}})
    return evs


def chrome_trace(result, spans=None, max_step_events: int = 20000,
                 max_span_events: int = 5000) -> Dict[str, object]:
    """Chrome trace-event dict for a ``SimResult``.

    pid 0 carries one track per replica with its prefill/decode step
    slices plus crash/restore instants; pid 1 carries one track per
    tenant with sampled request spans (async b/e, id = rid); pid 2
    carries autoscaler control instants.  Step/span event counts are
    capped (most recent kept) so traces of huge runs stay loadable —
    the truncation is reported in ``metadata``."""
    evs: List[dict] = []
    evs += _meta(0, "replicas")
    evs += _meta(1, "tenants")
    evs += _meta(2, "control")

    # -- replica step slices ------------------------------------------------
    sa = getattr(result, "step_arrays", None)
    if sa is not None:
        t_end = np.asarray(sa["t_end"], np.float64)
        rep = np.asarray(sa["replica"], np.int64)
        kind = np.asarray(sa["kind"])
        dur = np.asarray(sa["duration_s"], np.float64)
        bb = np.asarray(sa["bb"], np.int64)
        tok = np.asarray(sa["tokens_out"], np.int64)
        kind_name = np.where(np.asarray(kind) == 0, "prefill", "decode")
    else:
        steps = list(result.steps)
        t_end = np.array([s.t_end for s in steps], np.float64)
        rep = np.array([s.replica for s in steps], np.int64)
        kind_name = np.array([s.kind for s in steps], object)
        dur = np.array([s.duration_s for s in steps], np.float64)
        bb = np.array([s.bb for s in steps], np.int64)
        tok = np.array([s.tokens_out for s in steps], np.int64)
    n_steps = len(t_end)
    lo = max(0, n_steps - max_step_events)
    for i in range(lo, n_steps):
        evs.append({"name": str(kind_name[i]), "ph": "X", "pid": 0,
                    "tid": int(rep[i]),
                    "ts": (t_end[i] - dur[i]) * _US,
                    "dur": max(dur[i] * _US, 1.0),
                    "args": {"bb": int(bb[i]),
                             "tokens_out": int(tok[i])}})
    for r in sorted(set(rep.tolist())):
        evs += _meta(0, "replicas", tid=int(r), tname=f"replica {r}")

    # -- fault annotations --------------------------------------------------
    for ev in getattr(result, "fault_log", ()):
        evs.append({"name": f"{ev.kind} r{ev.replica}", "ph": "i",
                    "pid": 0, "tid": int(ev.replica), "ts": ev.t * _US,
                    "s": "g",
                    "args": {"n_displaced": int(ev.n_displaced)}})

    # -- control decisions --------------------------------------------------
    for t, action in getattr(result, "controls", ()):
        evs.append({"name": f"n_replicas={action.n_replicas}", "ph": "i",
                    "pid": 2, "tid": 0, "ts": float(t) * _US, "s": "t",
                    "args": {"batch_cap": int(action.batch_cap)}})

    # -- sampled request spans ---------------------------------------------
    if spans is None:
        spans = getattr(result, "spans", None)
    n_spans_src = 0
    if spans is not None and spans.n:
        n_spans_src = spans.n
        keep = min(spans.n, max_span_events)
        idx = np.argsort(spans.arrival_s)[-keep:]
        tenants = {t: i for i, t in
                   enumerate(sorted(set(spans.tenant.tolist())))}
        for t, tid in tenants.items():
            evs += _meta(1, "tenants", tid=tid, tname=t or "default")
        ttft = spans.ttft_s()
        for i in idx:
            tid = tenants[spans.tenant[i]]
            rid = int(spans.rid[i])
            t0 = float(spans.arrival_s[i])
            end = float(spans.done_s[i]) if np.isfinite(spans.done_s[i]) \
                else float(spans.shed_s[i]) \
                if np.isfinite(spans.shed_s[i]) else t0
            shed = bool(spans.shed[i])
            args = {"rid": rid, "ii": int(spans.ii[i]),
                    "oo": int(spans.oo[i]),
                    "retries": int(spans.retries[i])}
            if shed:
                args["shed_reason"] = str(spans.shed_reason[i])
            name = "shed" if shed else "request"
            common = {"cat": "request", "id": rid, "pid": 1, "tid": tid}
            evs.append({**common, "name": name, "ph": "b",
                        "ts": t0 * _US, "args": args})
            if np.isfinite(ttft[i]):
                evs.append({**common, "name": "first_token", "ph": "n",
                            "ts": (t0 + float(ttft[i])) * _US})
            evs.append({**common, "name": name, "ph": "e",
                        "ts": max(end, t0) * _US})

    return {"traceEvents": evs, "displayTimeUnit": "ms",
            "metadata": {"n_steps_total": int(n_steps),
                         "n_steps_emitted": int(n_steps - lo),
                         "n_spans_total": int(n_spans_src),
                         "sim_end_s": float(result.sim_end_s)}}


def write_chrome_trace(result, path, spans=None, **kw) -> pathlib.Path:
    path = pathlib.Path(path)
    path.write_text(json.dumps(chrome_trace(result, spans=spans, **kw)))
    return path


def _fmt(v: object) -> str:
    if isinstance(v, float):
        if not np.isfinite(v):
            return str(v)
        return f"{v:.3f}" if abs(v) < 1000 else f"{v:,.0f}"
    return str(v)


def scorecard_markdown(meta: Optional[Dict[str, object]] = None,
                       per_tenant: Optional[Dict[str, Dict]] = None,
                       calibration: Optional[Dict[str, object]] = None,
                       title: str = "Observability scorecard") -> str:
    """Markdown scorecard from the pieces ``BENCH_obs.json`` stores:
    fleet meta-metrics, the per-tenant rollup, and the calibration
    audit summary (``analysis/perf_report.py`` appends this section to
    its report)."""
    lines = [f"## {title}", ""]
    if meta:
        lines += ["| fleet metric | value |", "| --- | --- |"]
        lines += [f"| {k} | {_fmt(v)} |" for k, v in sorted(meta.items())]
        lines.append("")
    if per_tenant:
        cols = ("n_requests", "n_shed", "attainment", "ttft_p95_s",
                "goodput_share")
        lines += ["| tenant | " + " | ".join(cols) + " |",
                  "| --- |" + " --- |" * len(cols)]
        for name, row in sorted(per_tenant.items()):
            lines.append("| " + name + " | "
                         + " | ".join(_fmt(row.get(c)) for c in cols)
                         + " |")
        lines.append("")
    if calibration:
        lines += ["| calibration | value |", "| --- | --- |"]
        for k in ("n_ticks", "median_ape", "median_pred_err",
                  "median_confidence", "accuracy_rate",
                  "ape_over_pred_err"):
            if k in calibration:
                lines.append(f"| {k} | {_fmt(calibration[k])} |")
        rel = calibration.get("reliability")
        if rel and rel.get("bin_conf"):
            conf = ", ".join(f"{c:.2f}" for c in rel["bin_conf"])
            acc = ", ".join(f"{a:.2f}" for a in rel["bin_acc"])
            lines += ["",
                      f"Reliability curve (conf -> accuracy, "
                      f"{'monotone' if rel.get('monotone') else 'raw'}): "
                      f"[{conf}] -> [{acc}]"]
        lines.append("")
    return "\n".join(lines)
