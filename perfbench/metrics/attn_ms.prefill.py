"""Device ms of the traced request's prefill in attention: the CUDA-event
spans of its ``attn.proj`` and ``attn.kernel`` phases (K2 among them),
summed."""
from perfbench import phasespans


def read(run):
    return phasespans.prefill_ms(run, phasespans.ATTN)
