"""K2's share of its roofline in the traced request's prefill, %: its least
time (FLOPs over the bf16 peak or Q, K, V read and the output written
once over the memory's, whichever is longer) over its device time, a
launch on average."""
from perfbench import counts, devtrace


def read(run):
    t, x, p = run.trace, run.traced, run.peaks
    if t is None or p is None:
        return None
    ev = t.select(devtrace.kind_keys("K2"))
    if not ev:
        return None
    s, b, n = run.sizes, x["bb"], x["ii"]
    least = counts.least_s(
        counts.flash_attention_flops(b, n, n, s.heads, s.dh, True),
        counts.flash_attention_bytes(s, b, n),
        p["bf16_flops_s"], p["hbm_bytes_s"])
    device = sum(e[2] - e[1] for e in ev) / 1e9 / len(ev)
    return 100.0 * least / device
