"""Device ms a decode step spends in the FFN, in the traced request: the
replays' graph nodes the program labelled ``ffn`` (the dense SwiGLU) or
``moe.*`` (route, dispatch, the experts' products, combine)."""
from perfbench import phasespans


def read(run):
    return phasespans.decode_ms(run, phasespans.FFN)
