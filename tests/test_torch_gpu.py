"""The torch port's CUDA and Triton kernels against their plain versions,
on a CUDA card: the shape sweeps of ``test_kernels.py``, ragged lengths,
llama3.1-8b widths and a cache holding NaN past the fill level; then the
smoke model on the card against the same weights on the CPU.  Tolerances:
fp32 2e-5, bf16 2e-2, as ``test_kernels.py``.  The GBT-histogram kernel is
held to its exact contract: the bits of numpy's float32 ``np.add.at``; the
ALA's device paths (LM solve, forest traversal, bank distances) to their
CPU contracts, and a small ALA run's histogram launches to its tree
levels.  Every test needs a card and
skips without one; this file imports no JAX, so it runs where only torch
is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gbt_hist import ops as gh_ops
from repro_torch.kernels.gbt_hist.ref import gbt_hist_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
from repro_torch.models.transformer import Model

pytestmark = pytest.mark.gpu
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 \
        else dict(rtol=2e-5, atol=2e-5)


def _randn(gen, shape, dtype, device):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (17, 96),
                                   (8, 4096), (4096, 4096)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernel(cuda, shape, dtype):
    gen = torch.Generator(cuda).manual_seed(0)
    x = _randn(gen, shape, dtype, cuda)
    scale = _randn(gen, shape[-1:], torch.float32, cuda)
    n = rms_ops.rmsnorm.launches
    got = rms_ops.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm.launches == n + 1
    torch.testing.assert_close(got, rmsnorm_ref(x, scale), **_tol(dtype))


@pytest.mark.parametrize("b,h,kv,s,dh", [
    (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128),
    (2, 6, 2, 64, 32), (1, 4, 2, 50, 16), (2, 32, 8, 512, 128),
    (2, 32, 8, 1000, 128)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(cuda, b, h, kv, s, dh, causal, dtype):
    gen = torch.Generator(cuda).manual_seed(1)
    q = _randn(gen, (b, s, h, dh), dtype, cuda)
    k = _randn(gen, (b, s, kv, dh), dtype, cuda)
    v = _randn(gen, (b, s, kv, dh), dtype, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal).transpose(1, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **_tol(dtype))


@pytest.mark.parametrize("b,h,kv,t,dh", [
    (2, 8, 2, 128, 64), (1, 4, 4, 512, 128), (4, 16, 8, 256, 64),
    (3, 4, 2, 77, 16), (1, 32, 8, 576, 128), (8, 32, 8, 2080, 128),
    (64, 32, 8, 576, 128)])
@pytest.mark.parametrize("pos_frac", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel(cuda, b, h, kv, t, dh, pos_frac, dtype):
    gen = torch.Generator(cuda).manual_seed(2)
    q = _randn(gen, (b, h, dh), dtype, cuda)
    k = _randn(gen, (b, t, kv, dh), dtype, cuda)
    v = _randn(gen, (b, t, kv, dh), dtype, cuda)
    pos = int((t - 1) * pos_frac)
    got = da_ops.decode_attention(q, k, v, pos)
    want = decode_attention_ref(q.reshape(b, kv, h // kv, dh),
                                k.transpose(1, 2), v.transpose(1, 2), pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want.reshape(b, h, dh), **_tol(dtype))


def test_decode_attention_kernel_never_reads_past_pos(cuda):
    """NaN bits past pos must not reach the output (0 * NaN is NaN)."""
    gen = torch.Generator(cuda).manual_seed(3)
    q = _randn(gen, (2, 8, 64), torch.float32, cuda)
    k = _randn(gen, (2, 130, 2, 64), torch.float32, cuda)
    v = _randn(gen, (2, 130, 2, 64), torch.float32, cuda)
    want = da_ops.decode_attention(q, k, v, 70)
    k[:, 71:] = float("nan")
    v[:, 71:] = float("nan")
    got = da_ops.decode_attention(q, k, v, 70)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernels_refuse_misaligned_strides(cuda):
    q = torch.zeros((1, 8, 2, 17), device=cuda)[..., :16]
    with pytest.raises(ValueError, match="aligned"):
        fa_ops.flash_attention(q, q, q)


@pytest.mark.parametrize("dtype", DTYPES)
def test_smoke_model_on_card_matches_cpu(cuda, dtype):
    cfg = get_smoke_config("llama3.1-8b").scaled(compute_dtype=dtype)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    cpu = Model(cfg).load({n: p.cpu() for n, p in model.named_parameters()})
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(1))
    steps = torch.randint(0, cfg.vocab_size, (3, 2, 1),
                          generator=torch.Generator().manual_seed(2))
    counts = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches,
              da_ops.decode_attention.launches)
    got, gcache = model.prefill(toks.to(cuda), 48)
    want, ccache = cpu.prefill(toks, 48)
    torch.testing.assert_close(got.cpu(), want, **_tol(dtype))
    for tok in steps:
        got, gcache = model.decode_step(gcache, tok.to(cuda))
        want, ccache = cpu.decode_step(ccache, tok)
        torch.testing.assert_close(got.cpu(), want, **_tol(dtype))
    n_norm = 2 * cfg.n_layers + 1
    assert (rms_ops.rmsnorm.launches - counts[0],
            fa_ops.flash_attention.launches - counts[1],
            da_ops.decode_attention.launches - counts[2]) == \
        (4 * n_norm, cfg.n_layers, 3 * cfg.n_layers)


def _hist_inputs(seed, L, n, f, n_nodes, n_bins):
    """Seeded (bins, grad, hess, node) with ids out of range mixed in."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, n_bins + 1, (L, n, f)).astype(np.int32),
            rng.standard_normal((L, n)).astype(np.float32),
            rng.random((L, n)).astype(np.float32),
            rng.integers(-1, n_nodes + 1, (L, n)).astype(np.int32))


def _add_at(bins, grad, hess, node, n_nodes, n_bins):
    """float32 np.add.at in row order: the kernel's contract, bit for bit."""
    L, n, f = bins.shape
    out = np.zeros((L, n_nodes, f, n_bins, 2), np.float32)
    ok = ((bins >= 0) & (bins < n_bins) & (node[..., None] >= 0)
          & (node[..., None] < n_nodes))
    li, ri, fi = np.nonzero(ok)
    for k, w in enumerate((grad, hess)):
        np.add.at(out, (li, node[li, ri], fi, bins[li, ri, fi], k), w[li, ri])
    return out


@pytest.mark.parametrize("L,n,f,n_nodes,n_bins", [
    (1, 100, 3, 1, 16), (3, 48, 7, 16, 64), (15, 33, 7, 8, 64),
    (1, 190, 24, 16, 4), (1, 8192, 8, 1, 64), (2, 3000, 5, 4, 300),
    (1, 0, 2, 1, 8)])
def test_gbt_hist_kernel_is_np_add_at_bit_for_bit(cuda, L, n, f, n_nodes,
                                                   n_bins):
    arrays = _hist_inputs(0, L, n, f, n_nodes, n_bins)
    tensors = [torch.from_numpy(a).to(cuda) for a in arrays]
    launches = gh_ops.build_node_histograms.launches
    got = gh_ops.build_node_histograms(*tensors, n_nodes, n_bins)
    again = gh_ops.build_node_histograms(*tensors, n_nodes, n_bins)
    torch.cuda.synchronize()
    assert gh_ops.build_node_histograms.launches == launches + 2
    want = _add_at(*arrays, n_nodes, n_bins)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    assert torch.equal(got, again)
    torch.testing.assert_close(
        got, gbt_hist_ref(*tensors, n_nodes, n_bins), rtol=0, atol=1e-4)


def test_gbt_hist_kernel_batch_and_zero_weight_invariant(cuda):
    bins, grad, hess, node = _hist_inputs(1, 6, 80, 7, 8, 64)
    node = np.clip(node, 0, 7)
    full = gh_ops.build_node_histograms(
        *(torch.from_numpy(a).to(cuda) for a in (bins, grad, hess, node)),
        8, 64)
    alone = gh_ops.build_node_histograms(
        *(torch.from_numpy(np.ascontiguousarray(a[2:3])).to(cuda)
          for a in (bins, grad, hess, node)), 8, 64)
    assert torch.equal(full[2:3], alone)
    keep = np.random.default_rng(2).random(80) < 0.6
    w = keep.astype(np.float32)
    zeroed = gh_ops.build_node_histograms(
        *(torch.from_numpy(a).to(cuda) for a in (
            bins[:1], grad[:1] * w, hess[:1] * w, node[:1])), 8, 64)
    compact = gh_ops.build_node_histograms(
        *(torch.from_numpy(np.ascontiguousarray(a[:1, keep])).to(cuda)
          for a in (bins, grad, hess, node)), 8, 64)
    assert torch.equal(zeroed, compact)


def test_lm_solve_is_batch_invariant_on_the_card(cuda):
    from repro_torch.core import fit
    rng = np.random.default_rng(3)
    groups = [(np.arange(1.0, 11.0), 1000.0 - 800.0 * np.exp(
        -0.2 * np.arange(1.0, 11.0)) + rng.normal(0, 5, 10),
        np.array([800.0, 0.1, 1000.0])) for _ in range(7)]
    full = fit.fit_exponential_groups(groups, pad_to=16)
    for sel in ([2], [0, 5], [1, 3, 4, 6]):
        np.testing.assert_array_equal(
            fit.fit_exponential_groups([groups[i] for i in sel], pad_to=16),
            full[sel])
    np.testing.assert_allclose(full, fit.fit_exponential_groups(
        groups, pad_to=16, device="cpu"), rtol=1e-4)


def test_forest_traversal_and_bank_distances_on_the_card(cuda):
    from repro_torch.core import gbt, uncertainty
    from repro_torch.core.annealing import SALog
    rng = np.random.default_rng(4)
    X = rng.uniform(0, 10, (4, 120, 5))
    Y = np.stack([X[..., 0] * 3 + X[..., 1], np.sin(X[..., 2])], -1)
    forest = gbt.fit_packed_forest(X, Y, n_estimators=6, max_depth=3,
                                   n_bins=16)
    bins = forest.transform_bins(X)
    np.testing.assert_array_equal(forest._apply_torch(bins),
                                  forest._apply_numpy(bins))
    train = tuple(rng.choice([1.0, 2.0, 4.0, 8.0], 200) for _ in range(3)) \
        + (rng.uniform(10, 100, 200),)
    universes = {k: np.array([1.0, 2.0, 4.0, 8.0]) for k in ("ii", "oo", "bb")}
    subsets = [{k: frozenset(rng.choice(u, 2, replace=False).tolist())
                for k, u in universes.items()} for _ in range(20)]
    bank = uncertainty.build_subset_bank(train, SALog(
        subsets, [1.0] * 20, universes, subsets[0], 1.0))
    queries = [tuple(c[:50] for c in train), tuple(c[::3] for c in train)]
    np.testing.assert_allclose(
        uncertainty.bank_distances(bank, queries, backend="torch"),
        uncertainty.bank_distances(bank, queries, backend="numpy"),
        rtol=0, atol=1e-6)


def test_small_ala_launches_one_histogram_kernel_per_tree_level(cuda):
    from repro_torch.bench.datasets import (make_inhouse_dataset,
                                            train_test_split)
    from repro_torch.core import gbt
    from repro_torch.core.ala import ALA
    from repro_torch.core.annealing import SAConfig
    train, test = train_test_split(make_inhouse_dataset(), 0.3)
    ala = ALA()
    ala.cfg.gbt_kw = dict(n_estimators=10, learning_rate=0.2, max_depth=4)
    ala.cfg.sa = SAConfig(n_iters=2, gbt_kw=dict(n_estimators=5))
    launches = gh_ops.build_node_histograms.launches
    levels = gbt._joint_histograms.levels
    ala.fit(*train.workload)
    ala.explore(test.workload, n_chains=2)
    ala.fit_error(n_estimators=10)
    err, conf = ala.estimate(test.workload)
    assert np.isfinite(err) and 0.0 < conf <= 1.0 + 1e-6
    grown = gbt._joint_histograms.levels - levels
    assert gh_ops.build_node_histograms.launches - launches == grown > 0
