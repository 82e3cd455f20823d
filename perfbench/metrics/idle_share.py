"""The share of the traced request's wall time in which nothing ran on the
device, %: one less the union of its kernels, copies and sets over the
request's span."""


def read(run):
    t = run.trace
    if t is None or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s)
