"""Device ms of the traced request's prefill in moving tokens to and from
the experts: the CUDA-event spans of its ``moe.route``, ``moe.dispatch``
(argsort, ranks, the gather into the capacity buffer) and
``moe.combine`` phases, summed; 0 for a model without experts."""
from perfbench import phasespans


def read(run):
    return phasespans.prefill_ms(run, phasespans.DISPATCH)
