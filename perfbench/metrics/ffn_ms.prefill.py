"""Device ms of the traced request's prefill in the FFN: the CUDA-event
spans of its ``ffn`` and ``moe.*`` phases, summed."""
from perfbench import phasespans


def read(run):
    return phasespans.prefill_ms(run, phasespans.FFN)
