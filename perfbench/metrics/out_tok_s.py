"""Output tokens a second: every output token of the window's requests over
the window's wall time, from the first request's start to the last one's
end (host clock; each request ends in a synchronise)."""


def read(run):
    r = run.records
    tokens = sum(x["bb"] * x["oo"] for x in r)
    return tokens / (r[-1]["t1"] - r[0]["t0"])
