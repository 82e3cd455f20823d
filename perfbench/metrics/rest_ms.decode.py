"""Device ms a decode step spends outside attention and the FFN, in the
traced request: the replays' graph nodes the program labelled ``embed``,
``norm``, ``head`` or ``sample``, and those it left ``unlabelled``."""
from perfbench import phasespans


def read(run):
    return phasespans.decode_ms(run, phasespans.REST)
