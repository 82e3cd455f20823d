"""Alg 1 and Alg 2 of the port against the JAX package, on the in-repo
``inhouse`` data: features, initial parameters, the dataset and its split
bit for bit; the batched LM solve within float32 tolerance (fitted curves
within 1e-3 relative); and, exactly, the solve's batch invariance and the
incremental database refit."""
import numpy as np
import pytest
import torch

from repro.bench.datasets import load_or_make as jax_load_or_make
from repro.bench.datasets import make_inhouse_dataset as jax_make_inhouse
from repro.bench.datasets import train_test_split as jax_split
from repro.core import database as jdb
from repro.core import fit as jfit
from repro.core.expmodel import initial_params as jax_initial_params
from repro.core.features import engineer as jax_engineer

from repro_torch.bench import datasets
from repro_torch.core import database as tdb
from repro_torch.core import fit as tfit
from repro_torch.core.dataset import Dataset
from repro_torch.core.expmodel import exp_model, initial_params
from repro_torch.core.features import engineer
from repro_torch.weights import exp_database_from_reference

CURVE_RTOL = 1e-3     # float32 LM on two devices/frameworks, 60 steps


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensor ops: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def inhouse():
    return datasets.load_or_make("inhouse")


@pytest.fixture(scope="module")
def groups(inhouse):
    ii, oo, bb, thpt = inhouse.workload
    keys = np.stack([ii, oo], axis=1)
    uniq, inv = np.unique(keys, axis=0, return_inverse=True)
    return [(bb[inv == g], thpt[inv == g],
             initial_params(bb[inv == g], thpt[inv == g]))
            for g in range(len(uniq))]


def test_dataset_and_split_match_the_reference(inhouse):
    ref = jax_make_inhouse()
    assert len(inhouse) == len(ref) == 4800
    # the cache predates the hw_* descriptor columns the simulator adds
    for k in inhouse.cols:
        np.testing.assert_array_equal(inhouse[k], ref[k])
    for got, want in zip(datasets.train_test_split(inhouse, 0.3),
                         jax_split(jax_load_or_make("inhouse"), 0.3)):
        for k in inhouse.cols:
            np.testing.assert_array_equal(got[k], want[k])


def test_loader_raises_where_it_would_simulate():
    # the generators simulate since the simulator was ported: another
    # seed gives the reference's rows; only an unknown name raises
    got = datasets.make_inhouse_dataset(seed=3, reps=1)
    want = jax_make_inhouse(seed=3, reps=1)
    assert list(got.cols) == list(want.cols)
    for k in want.cols:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(KeyError):
        datasets.load_or_make("nope")


def test_dataset_round_trip(tmp_path, inhouse):
    inhouse.save(tmp_path / "d")
    back = Dataset.load(tmp_path / "d")
    assert all(np.array_equal(back[k], inhouse[k]) for k in inhouse.cols)
    rows = [dict(ii=1, oo=2, bb=3, thpt=4.0), dict(ii=5, oo=6, bb=7, thpt=8.0)]
    assert len(Dataset.from_rows(rows)) == 2
    with pytest.raises(ValueError, match="non-finite"):
        Dataset.from_rows([dict(ii=1, oo=2, bb=3, thpt=float("nan"))])


def test_features_and_initial_params_bit_equal(inhouse, groups):
    ii, oo, bb, thpt = inhouse.workload
    np.testing.assert_array_equal(engineer(ii, oo), jax_engineer(ii, oo))
    for gb, gt, theta0 in groups:
        np.testing.assert_array_equal(theta0, jax_initial_params(gb, gt))
    np.testing.assert_array_equal(initial_params(np.ones(3), np.ones(3)),
                                  [1.0, 0.001, 0.0])


def test_lm_solve_matches_jax_on_inhouse_groups(groups):
    got = tfit.fit_exponential_groups(groups, device="cpu")
    want = jfit.fit_exponential_groups(groups)
    assert got.shape == want.shape == (48, 3)
    for (gb, _, _), g, w in zip(groups, got, want):
        x = np.unique(gb)
        np.testing.assert_allclose(exp_model(x, *g), exp_model(x, *w),
                                   rtol=CURVE_RTOL)


def test_lm_solve_is_batch_invariant(groups):
    full = tfit.fit_exponential_groups(groups, device="cpu")
    pad = max(len(g[0]) for g in groups)
    for sel in ([3], [0, 7, 9], list(range(10, 31))):
        part = tfit.fit_exponential_groups([groups[i] for i in sel],
                                           pad_to=pad, device="cpu")
        np.testing.assert_array_equal(part, full[sel])


def test_masked_solve_matches_the_ragged_one(groups):
    gs = tdb.build_group_structure(
        *(np.concatenate(c) for c in zip(*[
            (np.full(len(b), 100.0 + i), np.full(len(b), 7.0), b, t)
            for i, (b, t, _) in enumerate(groups)])))
    theta0 = np.stack([g[2] for g in groups])
    got = tfit.fit_exponential_masked(theta0, gs.bb, gs.thpt, gs.row_w,
                                      device="cpu")
    want = jfit.fit_exponential_masked(theta0, gs.bb, gs.thpt, gs.row_w)
    for (gb, _, _), g, w in zip(groups, got, want):
        x = np.unique(gb)
        np.testing.assert_allclose(exp_model(x, *g), exp_model(x, *w),
                                   rtol=CURVE_RTOL)


def test_database_incremental_refit_is_bit_equal_to_a_full_build(inhouse):
    ii, oo, bb, thpt = inhouse.workload
    n_old = 4000
    full = tdb.build_exponential_database(ii, oo, bb, thpt, device="cpu")
    prev = tdb.build_exponential_database(ii[:n_old], oo[:n_old],
                                          bb[:n_old], thpt[:n_old],
                                          device="cpu")
    upd = tdb.update_exponential_database(prev, ii, oo, bb, thpt,
                                          n_delta=len(ii) - n_old,
                                          device="cpu")
    assert list(upd.params) == list(full.params)
    np.testing.assert_array_equal(upd.training, full.training)


def test_database_matches_the_reference(inhouse):
    ii, oo, bb, thpt = inhouse.workload
    got = tdb.build_exponential_database(ii, oo, bb, thpt, device="cpu")
    want = jdb.build_exponential_database(ii, oo, bb, thpt)
    assert list(got.params) == list(want.params)
    np.testing.assert_array_equal(got.training[:, :2], want.training[:, :2])
    for key in want.params:
        x = np.asarray([1.0, 8.0, 64.0, 512.0])
        np.testing.assert_allclose(tdb.db_predict(got, *key, x),
                                   jdb.db_predict(want, *key, x),
                                   rtol=CURVE_RTOL)
    conv = exp_database_from_reference(want)
    assert list(conv.params) == list(want.params)
    np.testing.assert_array_equal(conv.training, want.training)
    gs, js = (m.build_group_structure(ii, oo, bb, thpt) for m in (tdb, jdb))
    for k in ("keys", "bb", "thpt", "row_w", "bb_codes", "bb_universe",
              "bb_present"):
        np.testing.assert_array_equal(getattr(gs, k), getattr(js, k))


def test_fit_defaults_to_cuda_and_raises_without_it(monkeypatch, groups):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfit.fit_exponential_groups(groups[:2])
