"""The decode steps' share of the card's peak, %: the least time the
window's steps could take over their time.  A step's least time is the
larger of its FLOPs over the bf16 peak and its bytes (the weights it reads
and the K/V up to each position) over the memory's peak."""
from perfbench import counts


def read(run):
    if run.peaks is None:
        return None
    s, p = run.sizes, run.peaks
    least = sum(
        counts.least_s(counts.decode_step_flops(s, x["bb"], keys),
                       counts.decode_step_bytes(s, x["bb"], keys),
                       p["bf16_flops_s"], p["hbm_bytes_s"])
        for x in run.records for keys in counts.step_keys(x["ii"], x["oo"]))
    took = sum(x["decode_s"] for x in run.records)
    if not least or not took:
        return None
    return 100.0 * least / took
