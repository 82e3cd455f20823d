"""Alg 7 and Alg 8 of the port against the JAX package, fed the
reference's own ``SALog`` on ``inhouse`` rows.

Exact: the subset encodings, the error model's trees and predictions on
the float64 path, the bank's edges, counts, unit histograms and masks,
and the serial numpy distances.  Within 1e-6: the device distance path
against the serial numpy one (float32 cosine arithmetic; the reference's
own contract for its jitted kernel)."""
import numpy as np
import pytest

from repro.core import annealing as jann
from repro.core import error_predictor as jerr
from repro.core import uncertainty as junc

from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
from repro_torch.core import error_predictor as terr
from repro_torch.core import uncertainty as tunc
from repro_torch.weights import sa_log_from_reference, subset_bank_from_reference

BANK_FIELDS = ("inner_edges", "hist", "unit", "valid", "masks")


@pytest.fixture(scope="module")
def split():
    train, test = train_test_split(make_inhouse_dataset(), 0.3)
    return train.workload, test.workload


@pytest.fixture(scope="module")
def ref_log(split):
    """A reference SALog: seeded proposals with seeded errors."""
    ii, oo, bb, _ = split[0]
    universes = {"ii": np.unique(ii), "oo": np.unique(oo),
                 "bb": np.unique(bb)}
    rng = np.random.default_rng(0)
    subsets = [jann._sample_initial(universes, rng, 2)]
    for _ in range(60):
        subsets.append(jann._modify(subsets[-1], universes, rng, 2))
    errors = list(rng.uniform(5, 40, len(subsets)))
    return jann.SALog(subsets=subsets, errors=errors, universes=universes,
                      best_subset=subsets[int(np.argmin(errors))],
                      best_error=float(min(errors)))


@pytest.fixture(scope="module")
def queries(split):
    test = split[1]
    q0 = tuple(np.asarray(c[:300]) for c in test)
    q1 = tuple(np.asarray(c[::7]) for c in test)
    q2 = (q0[0], q0[1], q0[2], np.full(300, np.nan))
    q3 = tuple(np.asarray(c) * 50.0 for c in test)       # far outside
    return [q0, q1, q2, q3]


def test_encodings_and_error_model_bit_equal(ref_log):
    log = sa_log_from_reference(ref_log)
    np.testing.assert_array_equal(
        terr.encode_subsets(log.subsets, log.universes),
        jerr.encode_subsets(ref_log.subsets, ref_log.universes))
    kw = dict(n_estimators=30)
    got = terr.train_error_predictor(log, device="cpu", **kw)
    want = jerr.train_error_predictor(ref_log, **kw)
    for ta, tb in zip(got.trees_, want.trees_):
        for k in ("feature", "threshold", "left", "right", "value"):
            np.testing.assert_array_equal(getattr(ta, k), getattr(tb, k))
    probe = ref_log.subsets[::5]
    np.testing.assert_array_equal(
        terr.predict_error(got, probe, log.universes),
        jerr.predict_error(want, probe, ref_log.universes))
    np.testing.assert_array_equal(
        terr.predict_error(got, probe, log.universes, backend="torch"),
        jerr.predict_error(want, probe, ref_log.universes, backend="jax"))


def test_bank_bit_equal_to_the_reference(split, ref_log):
    got = tunc.build_subset_bank(split[0], sa_log_from_reference(ref_log))
    want = junc.build_subset_bank(split[0], ref_log)
    for k in BANK_FIELDS:
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        np.testing.assert_array_equal(
            getattr(subset_bank_from_reference(want), k), getattr(want, k))
    assert got.subsets == want.subsets


def test_bank_distances_torch_within_1e6_of_numpy(split, ref_log, queries):
    bank = tunc.build_subset_bank(split[0], sa_log_from_reference(ref_log))
    ref_bank = junc.build_subset_bank(split[0], ref_log)
    serial = tunc.bank_distances(bank, queries, backend="numpy")
    np.testing.assert_array_equal(
        serial, junc.bank_distances(ref_bank, queries, backend="numpy"))
    dev = tunc.bank_distances(bank, queries, backend="torch", device="cpu")
    assert dev.shape == (len(queries), bank.n_subsets)
    np.testing.assert_allclose(dev, serial, rtol=0, atol=1e-6)
    d_min, conf = tunc.bank_confidence(bank, queries, device="cpu")
    want_d, want_c = junc.bank_confidence(ref_bank, queries, backend="numpy")
    np.testing.assert_allclose(d_min, want_d, rtol=0, atol=1e-6)
    np.testing.assert_allclose(conf, want_c, rtol=0, atol=1e-6)


def test_serial_confidence_matches_the_reference(split, ref_log, queries):
    log = sa_log_from_reference(ref_log)
    for q in queries[:2]:
        assert tunc.confidence(split[0], log, q, max_subsets=20) == \
            junc.confidence(split[0], ref_log, q, max_subsets=20)


def test_degenerate_log_gives_the_sentinel(split, ref_log, queries):
    ii, oo, bb, _ = split[0]
    empty = {"ii": frozenset([-1.0]), "oo": frozenset([-1.0]),
             "bb": frozenset([-1.0])}
    log = tunc.SALog(subsets=[empty] * 3, errors=[1.0] * 3,
                     universes=sa_log_from_reference(ref_log).universes,
                     best_subset=empty, best_error=1.0)
    bank = tunc.build_subset_bank(split[0], log)
    for backend in ("torch", "numpy"):
        d_min, conf = tunc.bank_confidence(bank, queries[:2],
                                           backend=backend, device="cpu")
        assert np.all(np.isinf(d_min)) and np.all(conf == 0.0)
    assert tunc.confidence(split[0], log, queries[0]) == (np.inf, 0.0)


def test_extend_bank_equals_a_pinned_rebuild(split, ref_log):
    train = split[0]
    log = sa_log_from_reference(ref_log)
    n_old = 2500
    old = tuple(c[:n_old] for c in train)
    bank = tunc.build_subset_bank(old, tunc.SALog(
        subsets=log.subsets[:40], errors=log.errors[:40],
        universes=log.universes, best_subset=log.best_subset,
        best_error=log.best_error))
    grown = tunc.extend_bank(bank, train, len(train[0]) - n_old,
                             log.subsets[40:], log.universes)
    full = tunc.build_subset_bank(train, log, inner_edges=bank.inner_edges)
    for k in BANK_FIELDS:
        np.testing.assert_array_equal(getattr(grown, k), getattr(full, k))
