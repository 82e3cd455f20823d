"""Observability: the streaming metrics the serving engines read
(``metrics.py``).  Span tracing, the calibration audit and timeline
export are not ported yet (ROADMAP item 17)."""
from repro_torch.obs.metrics import (Counter, Gauge, RingLog, StreamHist,
                                     bucketize, fixed_edges,
                                     percentile_with_inf, tenant_rollup)

__all__ = [
    "Counter", "Gauge", "RingLog", "StreamHist", "bucketize", "fixed_edges",
    "percentile_with_inf", "tenant_rollup",
]
