"""Device ms a decode step spends in GEMM kernels (the projections, the
dense FFN or the experts' products, the head), in the traced request: the
kernels its graph replays launch whose names are a GEMM's."""
from perfbench import devtrace


def read(run):
    t, x = run.trace, run.traced
    if t is None or not t.graph_corr or x["oo"] < 2:
        return None
    ms = 1e3 * t.device_s(devtrace.kind_keys("GEMM"), phase="decode")
    return ms / (x["oo"] - 1) if ms else None
