"""A decode step, ms: the window's decode time (the engine's decode timers)
over all its steps, oo - 1 a request."""


def read(run):
    steps = sum(x["oo"] - 1 for x in run.records)
    if steps == 0:
        return None
    return 1e3 * sum(x["decode_s"] for x in run.records) / steps
