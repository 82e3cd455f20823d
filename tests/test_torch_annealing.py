"""Alg 6 of the port against the JAX package on ``inhouse``.

The proposal stream (seeded numpy) gives the reference's proposals
exactly.  Evaluations are compared on a fixed, seeded list of subsets,
never as whole trajectories: one flipped accept/reject sends a chain
elsewhere.  Tolerances: where every test row is a database hit (all ii and
oo values kept) the error is the LM fit alone and agrees within 1e-3
percentage points; where the Alg 3 GBT predicts the misses, the float32
LM's last bits can flip a split, so the gate is a median |diff| of at most
1 point and every |diff| at most 10 points (measured on the CPU: median
0.37, max 4.9 over 40 subsets)."""
import numpy as np
import pytest
import torch

from repro.core import annealing as jann

from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
from repro_torch.core import annealing as tann

GBT_KW = dict(n_estimators=20, learning_rate=0.2, max_depth=4)
HIT_TOL = 1e-3          # percentage points
MIXED_MEDIAN_TOL = 1.0
MIXED_MAX_TOL = 10.0


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
    train, test = train_test_split(make_inhouse_dataset(), 0.3)
    return train.workload, test.workload


@pytest.fixture(scope="module")
def universes(split):
    ii, oo, bb, _ = split[0]
    return {"ii": np.unique(ii), "oo": np.unique(oo), "bb": np.unique(bb)}


@pytest.fixture(scope="module")
def subsets(universes):
    rng = np.random.default_rng(0)
    mixed = [jann._sample_initial(universes, rng, 2) for _ in range(12)]
    hits = [dict(ii=frozenset(universes["ii"].tolist()),
                 oo=frozenset(universes["oo"].tolist()), bb=s["bb"])
            for s in mixed[:4]]
    return mixed, hits


def test_proposals_match_the_reference(universes):
    for seed in range(3):
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        sj = jann._sample_initial(universes, rj, 2)
        st = tann._sample_initial(universes, rt, 2)
        assert sj == st
        for _ in range(40):
            sj = jann._modify(sj, universes, rj, 2)
            st = tann._modify(st, universes, rt, 2)
            assert sj == st


def test_masks_and_metrics_match_the_reference(split, subsets):
    ii, oo, bb, thpt = split[0]
    mixed, hits = subsets
    np.testing.assert_array_equal(
        tann.batch_subset_masks(ii, oo, bb, mixed + hits),
        jann.batch_subset_masks(ii, oo, bb, mixed + hits))
    np.testing.assert_array_equal(tann.subset_mask(ii, oo, bb, mixed[0]),
                                  jann.subset_mask(ii, oo, bb, mixed[0]))
    assert tann.median_ape(thpt, thpt * 1.1) == \
        jann.median_ape(thpt, thpt * 1.1)


def test_merge_logs_matches_the_reference(subsets, universes):
    mixed, hits = subsets
    args = [dict(subsets=mixed[:3], errors=[1.0, 2.0, 3.0],
                 universes=universes, best_subset=mixed[0], best_error=1.0),
            dict(subsets=hits, errors=[4.0, 5.0, 6.0, 7.0],
                 universes={k: v[:3] for k, v in universes.items()},
                 best_subset=hits[1], best_error=5.0)]
    got = tann.merge_logs(*(tann.SALog(**a) for a in args))
    want = jann.merge_logs(*(jann.SALog(**a) for a in args))
    assert got.subsets == want.subsets and got.errors == want.errors
    assert got.best_subset == want.best_subset
    for k in want.universes:
        np.testing.assert_array_equal(got.universes[k], want.universes[k])


def test_evaluate_batch_matches_the_reference(split, subsets):
    mixed, hits = subsets
    got = tann._BatchedEvaluator(*split, GBT_KW, device="cpu") \
        .evaluate_batch(mixed + hits)
    want = jann._BatchedEvaluator(*split, GBT_KW, n_slots=16) \
        .evaluate_batch(mixed + hits)
    np.testing.assert_allclose(got[12:], want[12:], rtol=0, atol=HIT_TOL)
    diff = np.abs(got[:12] - want[:12])
    assert np.median(diff) <= MIXED_MEDIAN_TOL, diff
    assert diff.max() <= MIXED_MAX_TOL, diff


def test_evaluate_subset_matches_the_reference_on_hits(split, subsets):
    _, hits = subsets
    for s in hits[:2]:
        got = tann.evaluate_subset(*split, s, GBT_KW, device="cpu")
        want = jann.evaluate_subset(*split, s, GBT_KW)
        assert abs(got - want) <= HIT_TOL


def test_both_engines_log_every_proposal(split):
    cfg = tann.SAConfig(n_iters=3, gbt_kw=dict(GBT_KW, n_estimators=5),
                        n_chains=2)
    batched = tann.anneal_batched(*split, cfg, device="cpu")
    assert len(batched.subsets) == len(batched.errors) == 2 + 1 + 2 * 3
    assert batched.best_error == min(batched.errors)
    serial = tann.anneal(*split, cfg, device="cpu")
    assert len(serial.subsets) == 2 + 3
    assert all(np.isfinite(serial.errors))
