"""The ALA pipeline as a whole: the port's ``ALA(device="cpu")`` against the
JAX package's ``ALA`` on ``inhouse`` with a tiny SA, and the serving sweep
that feeds it.

Tolerances: held-out medAPE within 0.01 percentage points (it comes from
the LM fits alone: every test (ii, oo) is a database hit); seen-workload
predictions within 1e-3 relative; given the reference's SA log, the
predicted error bit-equal and the confidence within 1e-6 (the reference's
serial-vs-batched contract); ``estimate`` against ``estimate_batch``
within 1e-6 relative (error) and 1e-6 (confidence).  SA trajectories are
never compared."""
import numpy as np
import pytest
import torch

from repro.bench.datasets import make_inhouse_dataset as jax_make_inhouse
from repro.bench.datasets import train_test_split as jax_split
from repro.core.ala import ALA as JaxALA
from repro.core.annealing import SAConfig as JaxSAConfig

from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
from repro_torch.bench.harness import measure_arch
from repro_torch.core.ala import ALA
from repro_torch.core.annealing import SAConfig
from repro_torch.core.database import build_exponential_database
from repro_torch.weights import sa_log_from_reference

SA = dict(n_iters=3, gbt_kw=dict(n_estimators=8, learning_rate=0.2,
                                 max_depth=4))
PREDICTOR_KW = dict(n_estimators=10, learning_rate=0.2, max_depth=4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small tensor ops: one intra-op thread keeps parallel test workers
    from oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def split():
    return train_test_split(make_inhouse_dataset(), 0.3)


@pytest.fixture(scope="module")
def alas(split):
    train, test = split
    jtrain, jtest = jax_split(jax_make_inhouse(), 0.3)
    port = ALA(device="cpu")
    port.cfg.gbt_kw = dict(PREDICTOR_KW)
    port.cfg.sa = SAConfig(**SA)
    port.fit(*train.workload)
    ref = JaxALA()
    ref.cfg.gbt_kw = dict(PREDICTOR_KW)
    ref.cfg.sa = JaxSAConfig(**SA)
    ref.fit(*jtrain.workload)
    ref.explore(jtest.workload)
    ref.fit_error()
    return port, ref


def test_held_out_medape_and_seen_predictions_match(alas, split):
    port, ref = alas
    test = split[1].workload
    assert abs(port.score(*test) - ref.score(*test)) <= 0.01
    bb = np.array([1.0, 4.0, 16.0, 64.0, 256.0])
    np.testing.assert_allclose(port.predict(np.full(5, 1024.0),
                                            np.full(5, 512.0), bb),
                               ref.predict(np.full(5, 1024.0),
                                           np.full(5, 512.0), bb), rtol=1e-3)
    unseen = port.predict(np.full(5, 3000.0), np.full(5, 700.0), bb)
    assert np.all(np.isfinite(unseen)) and np.all(unseen >= 0)


def test_estimate_given_the_reference_log_matches(alas, split):
    port, ref = alas
    test = split[1].workload
    port.sa_log = sa_log_from_reference(ref.sa_log)
    port._bank = None
    port.fit_error()
    err, conf = port.estimate(test)
    want_err, want_conf = ref.estimate(test)
    assert err == want_err
    assert abs(conf - want_conf) <= 1e-6
    queries = [test, tuple(c[::5] for c in test)]
    got = port.estimate_batch(queries)
    want = ref.estimate_batch(queries, backend="jax")
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def test_explore_then_estimate_and_estimate_batch_agree(split):
    train, test = split
    ala = ALA(device="cpu")
    ala.cfg.gbt_kw = dict(PREDICTOR_KW)
    ala.cfg.sa = SAConfig(**SA)
    ala.fit(*train.workload)
    for chains in (1, 2):
        log = ala.explore(test.workload, n_chains=chains)
        assert len(log.subsets) == (2 if chains == 1 else 3) \
            + chains * SA["n_iters"]
        ala.fit_error(n_estimators=20)
        err, conf = ala.estimate(test.workload)
        b_err, b_dmin, b_conf = ala.estimate_batch([test.workload])
        # the serial path rounds lr * leaf to float32 per tree, the packed
        # one sums the float32 leaves in float64 first
        assert abs(b_err[0] - err) <= 1e-6 * abs(err)
        assert abs(b_conf[0] - conf) <= 1e-6
        assert 0.0 < conf <= 1.0 + 1e-6 and np.isfinite(b_dmin[0])
    assert set(ala.timings) >= {"fit_db_s", "fit_predictor_s", "explore_s",
                                "fit_error_s", "estimate_batch_s"}


def test_refit_on_appended_rows_matches_a_fresh_database(split):
    train, test = split
    ii, oo, bb, thpt = train.workload
    n_old = len(ii) - 300
    ala = ALA(device="cpu")
    ala.cfg.gbt_kw = dict(PREDICTOR_KW)
    ala.cfg.sa = SAConfig(**SA)
    ala.fit(ii[:n_old], oo[:n_old], bb[:n_old], thpt[:n_old])
    ala.explore(test.workload)
    ala.fit_error(n_estimators=10)
    ala.bank()
    ala.refit(train.workload, test.workload, n_iters=1)
    fresh = build_exponential_database(ii, oo, bb, thpt, device="cpu")
    np.testing.assert_array_equal(ala.db.training, fresh.training)
    assert ala.bank().masks.shape[1] == len(ii)


def test_ala_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ALA()


def test_measure_arch_rows_feed_the_database():
    ds = measure_arch("llama3.1-8b", grid_ii=(8, 16), grid_oo=(4,),
                      grid_bb=(1, 2, 4), reps=1, device="cpu")
    assert list(ds.cols) == ["model", "acc", "acc_count", "back", "prec",
                             "mode", "ii", "oo", "bb", "thpt"]
    assert len(ds) == 6 and set(ds["back"]) == {"repro-torch"}
    assert set(ds["acc"]) == {"cpu-host"} and set(ds["prec"]) == {"bf16"}
    assert np.all(ds["thpt"] > 0)
    db = build_exponential_database(*ds.workload, device="cpu")
    assert len(db) == 2 and np.all(np.isfinite(db.training))
