"""Observability layer: streaming metrics, request-span tracing, ALA
calibration audit, and timeline export.

The serving engines, autoscaler, and online loop all accept an
``ObsConfig`` hook (``SimConfig.obs``, ``ALAAutoscaler.obs``,
``OnlineALA(audit=...)``); everything here also works standalone on a
finished ``SimResult``.  A copy of the reference package's ``obs/``;
``bucketize`` is exported beside the reference's ``__all__``.
"""
from repro_torch.obs.calibration import (CalEvent, CalibrationAudit,
                                         reliability_curve)
from repro_torch.obs.export import (chrome_trace, scorecard_markdown,
                                    spans_to_dicts, write_chrome_trace,
                                    write_jsonl)
from repro_torch.obs.metrics import (Counter, Gauge, RingLog, StreamHist,
                                     bucketize, fixed_edges,
                                     percentile_with_inf, tenant_rollup)
from repro_torch.obs.tracing import (ObsConfig, SpanTable,
                                     queue_depth_series, record_spans,
                                     span_hists, span_stats)

__all__ = [
    "CalEvent", "CalibrationAudit", "reliability_curve",
    "chrome_trace", "scorecard_markdown", "spans_to_dicts",
    "write_chrome_trace", "write_jsonl",
    "Counter", "Gauge", "RingLog", "StreamHist", "bucketize", "fixed_edges",
    "percentile_with_inf", "tenant_rollup",
    "ObsConfig", "SpanTable", "queue_depth_series", "record_spans",
    "span_hists", "span_stats",
]
