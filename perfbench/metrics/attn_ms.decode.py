"""Device ms a decode step spends in attention, in the traced request:
the replays' graph nodes the program labelled ``attn.proj`` (the q, k, v
and o projections with their biases) or ``attn.kernel`` (RoPE, the K/V
write, K3)."""
from perfbench import phasespans


def read(run):
    return phasespans.decode_ms(run, phasespans.ATTN)
