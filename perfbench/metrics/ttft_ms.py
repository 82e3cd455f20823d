"""Time to first token, ms: the mean over the window's requests of the
engine's prefill timer (host clock from hand-over to the first token,
ending in a synchronise)."""


def read(run):
    r = run.records
    return 1e3 * sum(x["prefill_s"] for x in r) / len(r)
