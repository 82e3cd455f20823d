"""The prefills' model FLOP utilisation, %: the window's prefill FLOPs (2 x
the active parameters a token, experts at top-k, the head on each prompt's
last token, causal attention) over its prefill time, against the bf16
peak."""
from perfbench import counts


def read(run):
    if run.peaks is None:
        return None
    flops = sum(counts.prefill_flops(run.sizes, x["bb"], x["ii"])
                for x in run.records)
    took = sum(x["prefill_s"] for x in run.records)
    return 100.0 * flops / took / run.peaks["bf16_flops_s"]
