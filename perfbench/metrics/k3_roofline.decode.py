"""K3's share of its roofline in the traced request's decode steps, %: its
least time a launch (K/V up to the step's position, q and the output,
over the memory's peak, or its FLOPs over the bf16 peak), averaged over
the request's steps, over its device time a launch."""
from perfbench import counts, devtrace


def read(run):
    t, x, p = run.trace, run.traced, run.peaks
    if t is None or p is None:
        return None
    ev = t.select(devtrace.kind_keys("K3"))
    keys = list(counts.step_keys(x["ii"], x["oo"]))
    if not ev or not keys:
        return None
    s, b = run.sizes, x["bb"]
    least = sum(counts.least_s(
        counts.decode_attention_flops(b, s.heads, s.dh, k),
        counts.decode_attention_bytes(s, b, k),
        p["bf16_flops_s"], p["hbm_bytes_s"]) for k in keys) / len(keys)
    device = sum(e[2] - e[1] for e in ev) / 1e9 / len(ev)
    return 100.0 * least / device
