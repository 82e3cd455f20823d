"""The port's streaming metrics (``obs/metrics.py``) against the JAX
package's, bit for bit: ``percentile_with_inf``, ``fixed_edges`` and
``bucketize``, ``StreamHist`` (observe, merge, quantile, ``to_dict``),
``Counter``, ``Gauge``, ``RingLog`` and ``tenant_rollup``, on seeded
values with inf and NaN mass.  ``StreamHist.quantile`` is copied as it
stands, the reference's open question included: on ``seed=0,
inf_frac=0.53125`` (100 of 200 values inf) both return the same finite
50th percentile where ``percentile_with_inf`` says inf."""
import math

import numpy as np
import pytest
import torch

from repro.obs import metrics as jm

from repro_torch.obs import metrics as tm
from repro_torch.serving import simulator as tsim

QS = (0.0, 1.0, 10.0, 25.0, 50.0, 90.0, 95.0, 99.0, 100.0)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _vals(seed, n=300, inf=0.1, nan=0.03, neg=0.0):
    rng = np.random.default_rng(seed)
    v = rng.exponential(1.0, n)
    v[rng.random(n) < inf] = np.inf
    v[rng.random(n) < neg] = -np.inf
    v[rng.random(n) < nan] = np.nan
    return v


def _same_float(a, b):
    assert (math.isnan(a) and math.isnan(b)) or \
        np.float64(a).tobytes() == np.float64(b).tobytes(), (a, b)


def _same_hist(h, j):
    assert h.inner_edges.tobytes() == j.inner_edges.tobytes()
    assert h.counts.tobytes() == j.counts.tobytes()
    assert (h.n_inf, h.n_neg_inf, h.n_nan, h.total) == \
        (j.n_inf, j.n_neg_inf, j.n_nan, j.total)
    for q in QS:
        _same_float(h.quantile(q), j.quantile(q))
    assert h.to_dict() == j.to_dict()


@pytest.mark.parametrize("seed", range(4))
def test_percentile_with_inf_bit_equal(seed):
    for inf in (0.0, 0.1, 0.5):
        v = _vals(seed, 101 + seed, inf=inf, nan=0.0)
        for q in QS + (33.3, 66.7):
            _same_float(tm.percentile_with_inf(v, q),
                        jm.percentile_with_inf(v, q))
    assert tm.percentile_with_inf(np.array([]), 50.0) == float("inf")
    assert tsim.percentile_with_inf is tm.percentile_with_inf


@pytest.mark.parametrize("log", [False, True])
def test_fixed_edges_and_bucketize_bit_equal(log):
    rng = np.random.default_rng(1)
    for lo, hi, n in ((0.0, 8.0, 32), (1.0, 1e5, 48), (3.0, 3.0, 3),
                      (1e-12, 2.0, 17), (-5.0, 5.0, 10)):
        if log and lo <= 0:
            continue
        e, je = tm.fixed_edges(lo, hi, n, log=log), \
            jm.fixed_edges(lo, hi, n, log=log)
        assert e.dtype == je.dtype and e.tobytes() == je.tobytes()
        v = rng.uniform(lo - 1, hi + 1, 500)
        b, jb = tm.bucketize(v, e), jm.bucketize(v, je)
        assert b.dtype == jb.dtype and b.tobytes() == jb.tobytes()
    with pytest.raises(ValueError):
        tm.fixed_edges(0.0, 1.0, 2)


@pytest.mark.parametrize("seed", range(3))
def test_stream_hist_observe_merge_quantile_bit_equal(seed):
    shards = [_vals(seed * 10 + i, 150, neg=0.02) for i in range(4)]
    for log in (False, True):
        h = tm.StreamHist.from_range(0.01, 8.0, 32, log=log)
        j = jm.StreamHist.from_range(0.01, 8.0, 32, log=log)
        parts, jparts = [], []
        for i, s in enumerate(shards):
            w = np.random.default_rng(i).uniform(0.5, 2.0, len(s))
            parts.append(h.copy().observe(s, weights=w))
            jparts.append(j.copy().observe(s, weights=w))
        _same_hist(tm.StreamHist.merged(parts), jm.StreamHist.merged(jparts))
        _same_hist(tm.StreamHist.merged(parts[::-1]),
                   jm.StreamHist.merged(jparts[::-1]))
    whole = np.concatenate(shards)
    _same_hist(tm.StreamHist.from_values(whole, 24),
               jm.StreamHist.from_values(whole, 24))
    _same_hist(tm.StreamHist.from_values(np.array([np.inf, np.nan])),
               jm.StreamHist.from_values(np.array([np.inf, np.nan])))
    other = tm.StreamHist.from_range(0.0, 1.0, 8)
    with pytest.raises(ValueError, match="different edges"):
        tm.StreamHist.from_range(0.0, 2.0, 8).merge(other)
    with pytest.raises(ValueError, match="nothing to merge"):
        tm.StreamHist.merged([])


def test_stream_hist_inf_mass_case_as_the_reference():
    """The reference's open case (its ``test_hist_inf_mass_property``
    fails there): the port returns what the reference returns."""
    rng = np.random.default_rng(0)
    v = rng.exponential(1.0, 200)
    inf_mask = rng.random(200) < 0.53125
    v[inf_mask] = np.inf
    assert inf_mask.sum() == 100
    h = tm.StreamHist.from_values(v, 32)
    j = jm.StreamHist.from_values(v, 32)
    _same_hist(h, j)
    assert np.isfinite(h.quantile(50.0))                 # the open question
    assert tm.percentile_with_inf(v, 50.0) == float("inf")
    assert h.quantile(95.0) == float("inf")


def test_counter_gauge_ringlog_as_the_reference():
    c, jc = tm.Counter(), jm.Counter()
    g, jg = tm.Gauge(), jm.Gauge()
    g2, jg2 = tm.Gauge(), jm.Gauge()
    _same_float(g.mean, jg.mean)
    for i, v in enumerate(_vals(5, 40, inf=0.0, nan=0.0)):
        c.inc(v)
        jc.inc(v)
        (g if i % 3 else g2).set(v)
        (jg if i % 3 else jg2).set(v)
    c.merge(tm.Counter(2.5))
    jc.merge(jm.Counter(2.5))
    _same_float(c.value, jc.value)
    g.merge(g2)
    jg.merge(jg2)
    for k in ("n", "sum", "min", "max", "last", "mean"):
        _same_float(getattr(g, k), getattr(jg, k))
    r, jr = tm.RingLog(5, range(3)), jm.RingLog(5, range(3))
    for i in range(9):
        r.append(i)
        jr.append(i)
    r.extend("ab")
    jr.extend("ab")
    assert list(r) == list(jr) and r[1:3] == jr[1:3] and r[-1] == jr[-1]
    assert (len(r), r.n_total, r.n_dropped, repr(r)) == \
        (len(jr), jr.n_total, jr.n_dropped, repr(jr))
    r.clear()
    assert len(r) == 0 and r.n_total == 14
    with pytest.raises(ValueError):
        tm.RingLog(0)


@pytest.mark.parametrize("slo", [None, {"a": 0.5, "b": 2.0}])
def test_tenant_rollup_bit_equal(slo):
    rng = np.random.default_rng(3)
    n = 200
    tenant = rng.choice(["a", "b", "c"], n).astype(object)
    ttft = rng.exponential(1.0, n)
    shed = rng.random(n) < 0.1
    ttft[shed] = np.inf
    completed = ~shed & (rng.random(n) < 0.95)
    oo = rng.integers(1, 500, n)
    retries = rng.integers(0, 3, n)
    got = tm.tenant_rollup(tenant, ttft, oo, completed, shed, retries, slo)
    want = jm.tenant_rollup(tenant, ttft, oo, completed, shed, retries, slo)
    assert list(got) == list(want)
    for name in want:
        assert list(got[name]) == list(want[name])
        for k, v in want[name].items():
            _same_float(got[name][k], v)
