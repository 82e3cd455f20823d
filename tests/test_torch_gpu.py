"""The torch port's CUDA kernels against their plain versions,
on a CUDA card: the shape sweeps of ``test_kernels.py``, ragged lengths,
llama3.1-8b widths, a cache holding NaN past the fill level, decode
attention across its splits (bit-equal across calls, and within 1e-6 or
one bf16 ulp of its split arithmetic emulated in torch), both attentions
on strided views with NaN around them, flash attention with its bf16 products
on the tensor cores (in its SASS, spilling nothing) and, in bf16, within
one ulp of its rounding points emulated in torch, also where its
persistent blocks walk fewer items than SMs or many a block; RMSNorm fused with the residual add
(the sum bit for bit ``x + r``); decode attention captured in a CUDA graph
and replayed at positions across its splits, bit-equal to eager calls; then
the smoke model on the card against the same weights on the CPU, and its
decode step replayed as a CUDA graph bit for bit against the eager step,
through the serving engine too.  Tolerances:
fp32 2e-5, bf16 2e-2, as ``test_kernels.py``.  The GBT-histogram kernel is
held to its exact contract: the bits of numpy's float32 ``np.add.at``; the
ALA's device paths (LM solve, forest traversal, bank distances) to their
CPU contracts; K4's split step and its whole-fit kernel (``gbt_grow``,
one launch a fit) to their plain versions bit for bit, the forests grown
on the card to the host loop's over K4's plain histograms, and a small ALA
run's launches to its fits; the fleet engine's decode trajectories in
float64 on the card (``traj_backend="torch"``) against numpy's, bit for
bit on a dense config, within 1e-9 s on a MoE one, and refused without
a card; a traced, step-capped fleet run's spans and step log on the
card's trajectories equal to numpy's, and an audited ``OnlineALA`` on
the card whose refits each grow a fit in one ``gbt_grow`` launch; the
backward kernels (K1's plain and fused, K2's dQ, dK, dV from the
forward's LSE) against their plain versions and bit-equal over two runs,
and a smoke model's training step card against CPU.  Every
test that needs a card
skips without one; this file imports no JAX, so it runs where only torch
is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.emulate import \
    decode_attention_split_emulated
from repro_torch.kernels.decode_attention import kernel as da_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.emulate import (
    attention_bf16_emulated, attention_bwd_bf16_emulated)
from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                     attention_ref)
from repro_torch.kernels.gbt_hist import ops as gh_ops
from repro_torch.kernels.gbt_hist.cases import (KINDS, fit_case, fit_state,
                                                level_case, level_state)
from repro_torch.kernels.gbt_hist.ref import gbt_hist_ref
from repro_torch.kernels.rmsnorm import ops as rms_ops
from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                             add_rmsnorm_ref, rmsnorm_bwd_ref,
                                             rmsnorm_ref)
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


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (17, 96),
                                   (8, 4096), (32, 4096), (4096, 4096),
                                   (2, 33)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_add_rmsnorm_kernel(cuda, shape, dtype):
    """s is ``x + r`` bit for bit, y within the tolerance of the plain
    version; (2, 33) takes the kernel's path for rows that are not whole
    16-byte vectors."""
    gen = torch.Generator(cuda).manual_seed(9)
    x = _randn(gen, shape, dtype, cuda)
    r = _randn(gen, shape, dtype, cuda)
    scale = _randn(gen, shape[-1:], torch.float32, cuda)
    n = rms_ops.add_rmsnorm.launches
    s, y = rms_ops.add_rmsnorm(x, r, scale)
    torch.cuda.synchronize()
    assert rms_ops.add_rmsnorm.launches == n + 1
    want_s, want_y = add_rmsnorm_ref(x, r, scale)
    assert torch.equal(s.view(torch.uint8), want_s.view(torch.uint8))
    torch.testing.assert_close(y, want_y, **_tol(dtype))


def _flash_want(q, k, v, causal):
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal).transpose(1, 2)


@pytest.mark.parametrize("b,h,kv,s,dh", [
    (1, 4, 4, 128, 64), (2, 8, 2, 256, 64), (1, 4, 1, 128, 128),
    (2, 6, 2, 64, 32), (1, 4, 2, 50, 16), (2, 32, 8, 512, 128),
    (2, 32, 8, 1000, 128),
    # ragged S around the kernel's 64-row tiles, at every head size
    *[(2, 8, 2, s, dh) for s in (1, 63, 65, 127, 129, 1000)
      for dh in (16, 32, 64, 128)]])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel(cuda, b, h, kv, s, dh, causal, dtype):
    gen = torch.Generator(cuda).manual_seed(1)
    q = _randn(gen, (b, s, h, dh), dtype, cuda)
    k = _randn(gen, (b, s, kv, dh), dtype, cuda)
    v = _randn(gen, (b, s, kv, dh), dtype, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _flash_want(q, k, v, causal),
                               **_tol(dtype))


def _bf16_ulp(x):
    """One bf16 ulp at each |x|, floored at 1/16 (8 significant bits)."""
    _, exp = torch.frexp(x.float().abs().clamp(min=1 / 16))
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), exp - 8)


@pytest.mark.parametrize("s", [300, 320])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_kernel_matches_its_emulation(cuda, s, causal):
    """K2's bf16 output within one bf16 ulp of ``attention_bf16_emulated``
    (its rounding points in plain torch) on the inputs and at the widths of
    ``test_torch_kernels.py``'s comparison of that emulation with the JAX
    flash kernel: Dh 128, GQA 4:1."""
    gen = torch.Generator(cuda).manual_seed(8)
    q = _randn(gen, (1, s, 8, 128), torch.bfloat16, cuda)
    k = _randn(gen, (1, s, 2, 128), torch.bfloat16, cuda)
    v = _randn(gen, (1, s, 2, 128), torch.bfloat16, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=causal).cpu().float()
    want = attention_bf16_emulated(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    err = (got - want.float()).abs() / _bf16_ulp(want)
    assert err.max() <= 1, f"{err.max():.3g} ulp"


@pytest.mark.parametrize("s", [65, 129])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_reads_only_its_views(cuda, s, dh, causal,
                                                     dtype):
    """q, k, v are strided views into one buffer whose other rows, heads
    and columns hold NaN: any read outside the views reaches the output."""
    gen = torch.Generator(cuda).manual_seed(5)
    buf = torch.full((2, s + 7, 14, dh + 16), float("nan"), dtype=dtype,
                     device=cuda)
    rows, cols = slice(3, 3 + s), slice(8, 8 + dh)
    q, k, v = (buf[:, rows, 0:8, cols], buf[:, rows, 9:11, cols],
               buf[:, rows, 12:14, cols])
    for x in (q, k, v):
        x.copy_(_randn(gen, x.shape, dtype, cuda))
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _flash_want(q, k, v, causal),
                               **_tol(dtype))


def test_flash_attention_bf16_kernels_use_the_tensor_cores(cuda):
    """Every bf16 instantiation of the kernel holds HMMA or HGMMA
    instructions in its SASS (``cuobjdump -sass`` of the built library)."""
    from repro_torch.kernels import _build
    counts = _build.tensor_core_counts("flash_attention")
    bf16 = {k: n for k, n in counts.items() if "flash_fwd_bf16" in k}
    assert len(bf16) == len(_build.HEAD_DIMS)
    assert all(n > 0 for n in bf16.values()), bf16


# K2's bf16 forward walks its work items (128 query rows of one head of
# one sequence) by min(items, SMs) persistent blocks: fewer items than
# SMs, a ragged Sq of many items a block, Sq != Sk both ways, every head
# size
PERSISTENT_CASES = [
    (1, 64, 64, 1, 1, 64, True), (1, 64, 64, 1, 1, 64, False),
    (16, 1500, 1500, 16, 16, 64, False), (16, 1500, 1500, 16, 16, 64, True),
    (2, 300, 700, 8, 2, 128, False), (2, 300, 700, 8, 2, 128, True),
    (2, 700, 300, 8, 2, 128, True), (3, 1, 130, 4, 4, 64, True),
    *[(2, 333, 333, 8, 2, dh, causal) for dh in (16, 32, 64, 128)
      for causal in (True, False)]]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal", PERSISTENT_CASES)
def test_flash_attention_persistent_forward(cuda, b, sq, sk, h, kv, dh,
                                            causal):
    """The bf16 forward against ``attention_bf16_emulated`` (computed on
    the card in fp32): within one bf16 ulp (floored at 1/16) but for at
    most 0.1% of the elements, which stay within 8, the backward's
    contract.  The kernel's ex2.approx flips the bf16 rounding of a few P
    elements, and where a row's sum cancels that is several ulps of a
    small output (4 at B 2, S 1,000, 8/2 heads, Dh 128, causal, on an
    H100).  Also within bf16's tolerance of the plain version, its lse
    within that tolerance of the plain lse, one launch a call, and the
    same bits with and without the lse and over two runs."""
    gen = torch.Generator(cuda).manual_seed(31)
    q = _randn(gen, (b, sq, h, dh), torch.bfloat16, cuda)
    k, v = (_randn(gen, (b, sk, kv, dh), torch.bfloat16, cuda)
            for _ in range(2))
    n = fa_ops.flash_attention.launches
    out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
    again = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == n + 2
    assert torch.equal(out, again)
    want = attention_bf16_emulated(q, k, v, causal=causal)
    err = (out.float() - want.float()).abs() / _bf16_ulp(want)
    assert err.max() <= 8, f"{err.max():.3g} ulp"
    assert (err > 1).float().mean() <= 1e-3, \
        f"{(err > 1).float().mean():.3g} of the elements beyond one ulp"
    plain, plain_lse = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal,
                                     return_lse=True)
    tol = _tol(torch.bfloat16)
    torch.testing.assert_close(out, plain.transpose(1, 2), **tol)
    torch.testing.assert_close(lse, plain_lse, **tol)


def test_flash_attention_smem_mirror_is_the_kernels(cuda):
    """The persistent walk's Python mirror counts the bf16 forward's
    shared memory and threads as the built kernel does, at every head
    size."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    lib = _build.load("flash_attention")
    assert lib.flash_attention_threads(1) == fa_kernel.THREADS
    for dh in _build.HEAD_DIMS:
        assert lib.flash_attention_smem_bytes(1, dh) == \
            fa_kernel.fwd_smem_bytes(dh)


def test_flash_attention_bf16_forward_spills_nothing(cuda):
    """Every bf16 forward (``flash_fwd_bf16<Dh>``) holds HGMMA (wgmma)
    instructions and spills no register (its ptxas report)."""
    from repro_torch.kernels import _build
    kinds = _build.tensor_core_kinds("flash_attention")
    report = _build.ptxas_report("flash_attention")
    bf16 = [k for k in kinds if "flash_fwd_bf16" in k]
    assert len(bf16) == len(_build.HEAD_DIMS), sorted(kinds)
    assert all(kinds[k]["HGMMA"] > 0 and report[k][1] == 0 for k in bf16), \
        {k: (kinds[k], report[k]) for k in bf16}


def _decode_want(q, k, v, pos):
    b, h, dh = q.shape
    kv = k.shape[2]
    return decode_attention_ref(q.reshape(b, kv, h // kv, dh),
                                k.transpose(1, 2), v.transpose(1, 2),
                                pos).reshape(b, h, dh)


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
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _decode_want(q, k, v, pos), **_tol(dtype))


def _split_positions(t, n_split):
    """pos at 0; nearest t / 2, where the last split ends full (a split
    boundary - 1), holds one row (on it) and two rows (+ 1); at t - 1."""
    def last_rows(p):
        return (p + 1) % da_kernel.splits_of(p, n_split)[1]
    return (0, *(min((p for p in range(t) if last_rows(p) == r),
                     key=lambda p: abs(p - t // 2)) for r in (0, 1, 2)),
            t - 1)


def _decode_split(q, k, v, pos, n_split):
    """The kernel with its positions cut into at most n_split splits."""
    out = torch.empty_like(q)
    da_kernel.decode_attention_bhd(
        q, k, v, out, torch.tensor([pos], device=q.device), n_split,
        q.shape[-1] ** -0.5)
    return out


@pytest.mark.parametrize("b,n_split", [(1, None), (8, 5)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_graph_follows_the_device_position(cuda, b,
                                                            n_split, dtype):
    """One launch captured in a CUDA graph, replayed with the position
    changed in device memory between replays, at positions that cross
    split boundaries: bit-equal at each to the eager call at that int
    position (the plan's splits, None, or a grid of n_split)."""
    h, kv, t, dh = 32, 8, 2080, 128
    gen = torch.Generator(cuda).manual_seed(10)
    q = _randn(gen, (b, h, dh), dtype, cuda)
    k = _randn(gen, (b, t, kv, dh), dtype, cuda)
    v = _randn(gen, (b, t, kv, dh), dtype, cuda)
    pos_t = torch.zeros(1, dtype=torch.int64, device=cuda)

    def call(pos):
        if n_split is None:
            return da_ops.decode_attention(q, k, v, pos)
        out = torch.empty_like(q)
        p = pos if isinstance(pos, torch.Tensor) else torch.tensor(
            [pos], device=cuda)
        da_kernel.decode_attention_bhd(q, k, v, out, p, n_split, dh ** -0.5)
        return out
    call(pos_t)  # builds and configures the kernel outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call(pos_t)
    plan = n_split or da_kernel.split_count(b, kv, h // kv,
                                            da_kernel.sm_count(0))
    live = set()
    for pos in (0, 63, 64, 300, 319, 320, 700, 1000, 1500, 2079):
        pos_t.fill_(pos)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, call(pos)), pos
        live.add(da_kernel.splits_of(pos, plan)[0])
    assert len(live) >= 3, live


@pytest.mark.parametrize("b,n_split", [(1, None), (8, None), (8, 2),
                                       (8, 5)])
@pytest.mark.parametrize("which", range(5))
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_across_splits(cuda, b, n_split, which,
                                               dtype):
    """At llama3.1-8b's heads and a 2,080-slot cache, with the plan's
    n_split (None) or a given one: within the tolerance of the plain
    version, within 1e-6 (fp32) or one bf16 ulp of
    ``decode_attention_split_emulated`` at the same splits, and bit-equal
    across two calls."""
    h, kv, t, dh = 32, 8, 2080, 128
    gen = torch.Generator(cuda).manual_seed(6)
    q = _randn(gen, (b, h, dh), dtype, cuda)
    k = _randn(gen, (b, t, kv, dh), dtype, cuda)
    v = _randn(gen, (b, t, kv, dh), dtype, cuda)
    if n_split is None:  # the wrapper with its own plan

        def plan(p):
            return da_kernel.split_plan(b, kv, h // kv, p,
                                        da_kernel.sm_count(0))[0]
        pos = _split_positions(t, plan(t - 1))[which]
        n_split = plan(pos)
        got = da_ops.decode_attention(q, k, v, pos)
        again = da_ops.decode_attention(q, k, v, pos)
    else:
        pos = _split_positions(t, n_split)[which]
        got = _decode_split(q, k, v, pos, n_split)
        again = _decode_split(q, k, v, pos, n_split)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    torch.testing.assert_close(got, _decode_want(q, k, v, pos), **_tol(dtype))
    want = decode_attention_split_emulated(q.cpu(), k.cpu(), v.cpu(), pos,
                                           n_split)
    if dtype == torch.float32:
        torch.testing.assert_close(got.cpu(), want, rtol=1e-6, atol=1e-6)
    else:
        err = (got.cpu().float() - want.float()).abs() / _bf16_ulp(want)
        assert err.max() <= 1, f"{err.max():.3g} ulp"


@pytest.mark.parametrize("b,t,pos,dtype,n_split", [
    (2, 130, 70, torch.float32, None), (8, 2080, 1000, torch.bfloat16, 5),
    (1, 2080, 1500, torch.float32, None),
    (1, 2080, 1500, torch.bfloat16, None)])
def test_decode_attention_kernel_never_reads_past_pos(cuda, b, t, pos, dtype,
                                                      n_split):
    """NaN bits past pos must not reach the output (0 * NaN is NaN), with
    one split or several (the plan's, None, or n_split)."""
    gen = torch.Generator(cuda).manual_seed(3)
    kv, dh = (2, 64) if t < 1000 else (8, 128)
    q = _randn(gen, (b, 4 * kv, dh), dtype, cuda)
    k = _randn(gen, (b, t, kv, dh), dtype, cuda)
    v = _randn(gen, (b, t, kv, dh), dtype, cuda)

    def run():
        if n_split is None:
            return da_ops.decode_attention(q, k, v, pos)
        return _decode_split(q, k, v, pos, n_split)
    want = run()
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    got = run()
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("b,t,pos", [(2, 130, 129), (8, 600, 575),
                                     (1, 2080, 2000)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_reads_only_its_views(cuda, b, t, pos, dtype):
    """q and the cache are strided views into buffers whose other rows,
    heads and columns hold NaN: any read outside the views reaches the
    output."""
    gen = torch.Generator(cuda).manual_seed(7)
    dh = 128
    qbuf = torch.full((b, 40, dh + 16), float("nan"), dtype=dtype,
                      device=cuda)
    cbuf = torch.full((b, t + 9, 19, dh + 16), float("nan"), dtype=dtype,
                      device=cuda)
    q = qbuf[:, 3:35, 8:8 + dh]
    k, v = cbuf[:, 4:4 + t, 1:9, 8:8 + dh], cbuf[:, 4:4 + t, 10:18, 8:8 + dh]
    for x in (q, k, v):
        x.copy_(_randn(gen, x.shape, dtype, cuda))
    got = da_ops.decode_attention(q, k, v, pos)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _decode_want(q, k, v, pos), **_tol(dtype))


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
              da_ops.decode_attention.launches, rms_ops.add_rmsnorm.launches)
    got, gcache = model.prefill(toks.to(cuda), 48)
    want, ccache = cpu.prefill(toks, 48)
    torch.testing.assert_close(got.cpu(), want, **_tol(dtype))
    for tok in steps:
        got, gcache = model.decode_step(gcache, tok.to(cuda))
        want, ccache = cpu.decode_step(ccache, tok)
        torch.testing.assert_close(got.cpu(), want, **_tol(dtype))
    assert (rms_ops.rmsnorm.launches - counts[0],
            rms_ops.add_rmsnorm.launches - counts[3],
            fa_ops.flash_attention.launches - counts[1],
            da_ops.decode_attention.launches - counts[2]) == \
        (4, 4 * 2 * cfg.n_layers, cfg.n_layers, 3 * cfg.n_layers)


@pytest.mark.parametrize("dtype", DTYPES)
def test_graphed_decode_is_the_eager_step_bit_for_bit(cuda, dtype):
    """16 replays of the captured step against 16 eager greedy steps from
    the same prefill: the same logits and tokens, bit for bit, and the
    kernels' counters ticked at capture only."""
    from repro_torch.inference.engine import DecodeGraph
    from repro_torch.inference.sampling import sample
    cfg = get_smoke_config("llama3.1-8b").scaled(compute_dtype=dtype)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (3, 20), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(4))
    graph = DecodeGraph(model, 3, 40)
    counts = (rms_ops.add_rmsnorm.launches, da_ops.decode_attention.launches)
    logits, cache = model.prefill(toks, 40)
    tok = sample(logits, vocab_size=cfg.vocab_size)
    want = []
    for _ in range(16):
        logits, cache = model.decode_step(cache, tok)
        tok = sample(logits, vocab_size=cfg.vocab_size)
        want.append((logits.clone(), tok))
    logits, _ = model.prefill(toks, cache=graph.cache)
    graph.start(sample(logits, vocab_size=cfg.vocab_size))
    n = (rms_ops.add_rmsnorm.launches, da_ops.decode_attention.launches)
    for i, (wl, wt) in enumerate(want):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.logits, wl), i
        assert torch.equal(graph.tok, wt), i
    assert (rms_ops.add_rmsnorm.launches, da_ops.decode_attention.launches) \
        == n
    assert n[1] - counts[1] == 16 * cfg.n_layers
    assert int(graph.cache.pos_t) == 36
    for kv, ref in zip(graph.cache.blocks, cache.blocks):
        assert torch.equal(kv.k[:, :, :36], ref.k[:, :, :36])


def test_decode_graph_lists_the_step_kernels(cuda):
    """The captured step's kernel nodes, read from the graph: one K1 a norm
    (2 a block and the final one), one K3 a block, no prefill attention."""
    from repro_torch.inference.engine import DecodeGraph
    cfg = get_smoke_config("llama3.1-8b").scaled(compute_dtype=torch.bfloat16)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    names = DecodeGraph(model, 2, 24).kernel_names()
    assert sum("rmsnorm" in n for n in names) == 2 * cfg.n_layers + 1
    assert sum("decode_attn" in n for n in names) == cfg.n_layers
    assert not any("flash_fwd" in n for n in names)


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_engine_replays_the_graph_and_gives_the_eager_tokens(cuda,
                                                             temperature):
    """``ServingEngine.generate`` on the card captures once per signature
    and replays a step per token; its tokens are an eager loop's, with the
    same generator at temperature > 0."""
    from repro_torch.inference.engine import ServingEngine
    from repro_torch.inference.sampling import sample
    cfg = get_smoke_config("llama3.1-8b").scaled(compute_dtype=torch.bfloat16)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    engine = ServingEngine(model, temperature=temperature)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 12))
    got = [engine.generate(prompts, 9).tokens for _ in range(2)]
    assert (engine.captures, engine.replays) == (1, 16)
    gen = torch.Generator(cuda).manual_seed(0)
    logits, cache = model.prefill(torch.from_numpy(prompts).to(cuda), 21)
    toks = [sample(logits, gen, temperature, vocab_size=cfg.vocab_size)]
    for _ in range(8):
        logits, cache = model.decode_step(cache, toks[-1])
        toks.append(sample(logits, gen, temperature,
                           vocab_size=cfg.vocab_size))
    want = torch.cat(toks, 1).cpu().numpy()
    np.testing.assert_array_equal(got[0], want)
    np.testing.assert_array_equal(got[1], want)
    engine.generate(prompts[:2], 3)
    assert (engine.captures, engine.replays) == (2, 18)


def test_engine_captures_once_a_signature_under_the_compile_gate(cuda):
    """The tracers count the engine's decode-graph captures: one for a new
    signature, none at the same signature again."""
    from repro_torch.inference.engine import ServingEngine
    from repro_torch.kernels import _build
    from repro_torch.staticcheck.tracers import (assert_max_compiles,
                                                 count_compiles)
    _build.build()  # a build inside the gate would count too
    cfg = get_smoke_config("llama3.1-8b").scaled(compute_dtype=torch.bfloat16)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    engine = ServingEngine(model)
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (4, 12))
    with count_compiles("first signature") as rep:
        engine.generate(prompts, 9)
    assert (rep.n_captures, rep.n_builds, rep.n_frames) == (1, 0, 0)
    assert engine.captures == 1
    with assert_max_compiles(0, label="same signature") as rep:
        engine.generate(prompts, 9)
    assert rep.count == 0 and engine.captures == 1


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


GROW_STATE = ("pred", "grad", "node", "level", "feature", "threshold",
              "left", "right", "value", "n_nodes")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [1, 4, 16])
@pytest.mark.parametrize("n_bins", [4, 16, 64, 128])
def test_split_step_kernel_is_its_plain_version_bit_for_bit(cuda, n_bins,
                                                             width, kind):
    c = level_case(n_bins + width, 3, width, 7, n_bins, kind, n=300)
    depth = width.bit_length() - 1
    for max_depth in (depth, depth + 1):         # the last level, a search
        card = level_state(c, 2, max_depth, cuda)
        plain = level_state(c, 2, max_depth, "cpu")
        launches = gh_ops.split_level.launches
        for s, dev in ((card, cuda), (plain, "cpu")):
            gh_ops.split_level(torch.from_numpy(c["hist"]).to(dev), s, 1,
                               depth, max_depth, 1.0, c["mcw"], 0.1)
        torch.cuda.synchronize()
        assert gh_ops.split_level.launches == launches + 1
        for k in GROW_STATE:
            got, want = getattr(card, k).cpu(), getattr(plain, k)
            assert got.numpy().tobytes() == want.numpy().tobytes(), k


@pytest.mark.parametrize("path", ["grow", "levels"])
@pytest.mark.parametrize("max_depth", [1, 2, 3, 4])
@pytest.mark.parametrize("C,O,n,f,n_bins", [(1, 1, 125, 24, 4),
                                            (5, 3, 48, 7, 64)])
def test_forests_grown_on_the_card_are_the_host_loops(cuda, monkeypatch, C, O,
                                                      n, f, n_bins, max_depth,
                                                      path):
    """L 1 and L 15: the forests grown on the card against the host loop
    over K4's plain histograms on the CPU, bit for bit, on both of the
    card's paths: one ``gbt_grow`` launch a fit and no launch a level, or
    (``fits_on_chip`` made to refuse the fit) the level path's two
    launches a level."""
    from repro_torch.core import gbt
    if path == "levels":
        monkeypatch.setattr(gh_ops, "fits_on_chip", lambda *a: False)
    rng = np.random.default_rng(max_depth)
    X = rng.uniform(0, 10, (C, n, f))
    Y = np.stack([X[..., 0] * 3 + X[..., 1], np.sin(X[..., 2]),
                  X[..., 1] ** 2][:O], -1)
    W = (rng.random((C, n)) < 0.7).astype(np.float64)
    kw = dict(n_estimators=6, max_depth=max_depth, n_bins=n_bins)
    counts = (gh_ops.build_node_histograms.launches,
              gh_ops.split_level.launches, gh_ops.grow_fit.launches,
              gbt.grow_forests.levels)
    got = gbt.fit_packed_forest(X, Y, W, **kw)
    want = gbt.fit_packed_forest(X, Y, W, use_kernel=True, device="cpu", **kw)
    levels = 6 * (max_depth + 1)
    want_counts = ((0, 0, 1, levels) if path == "grow"
                   else (levels, levels, 0, levels))
    assert (gh_ops.build_node_histograms.launches - counts[0],
            gh_ops.split_level.launches - counts[1],
            gh_ops.grow_fit.launches - counts[2],
            gbt.grow_forests.levels - counts[3]) == want_counts
    for k in ("feature", "threshold", "left", "right", "value", "n_nodes",
              "base"):
        assert np.array_equal(getattr(got, k), getattr(want, k)), k
    if C == 1:
        card = gbt.GBTRegressor(**kw).fit(X[0], Y[0, :, 0])
        host = gbt.GBTRegressor(use_kernel=True, device="cpu", **kw).fit(
            X[0], Y[0, :, 0])
        for a, b in zip(card.trees_, host.trees_):
            for k in ("feature", "threshold", "left", "right", "value"):
                assert np.array_equal(getattr(a, k), getattr(b, k)), k


# (L, n, f, n_bins, max_depth, trees, distinct bin ids a feature): the main
# path's fits (Alg 3, the registry, Alg 7, the two baseline GBTs; trees
# cut for the plain version's time on the CPU) and the kernel's edges: a
# lone feature and bin at depth 0, 17 features over 6 blocks at 128 bins,
# depth 8
GROW_CASES = [(3, 48, 7, 64, 4, 8, 0), (114, 16, 7, 64, 4, 2, 0),
              (1, 125, 24, 4, 4, 20, 2), (1, 3360, 3, 64, 6, 4, 8),
              (1, 3360, 3, 64, 3, 8, 8), (2, 10, 1, 1, 0, 3, 0),
              (2, 100, 17, 128, 5, 3, 0), (2, 40, 9, 16, 8, 3, 0)]


@pytest.mark.parametrize("case", GROW_CASES)
def test_grow_kernel_is_its_plain_version_bit_for_bit(cuda, case):
    """One ``gbt_grow`` launch against ``gbt_grow_ref`` on the CPU (whose
    fp32 histograms add in row order), in every tensor of the state; the
    last problem has no row in the fit."""
    L, n, f, n_bins, max_depth, trees, distinct = case
    c = fit_case(sum(case), L, n, f, n_bins, distinct=distinct)
    c["w"][-1] = 0.0 if L > 1 else c["w"][-1]
    card = fit_state(c, trees, max_depth, cuda)
    plain = fit_state(c, trees, max_depth, "cpu")
    launches = gh_ops.grow_fit.launches
    gh_ops.grow_fit(card, trees, max_depth, n_bins, 1.0, 1.0, 0.1)
    torch.cuda.synchronize()
    assert gh_ops.grow_fit.launches == launches + 1
    gh_ops.grow_fit(plain, trees, max_depth, n_bins, 1.0, 1.0, 0.1)
    for k in GROW_STATE:
        got, want = getattr(card, k).cpu(), getattr(plain, k)
        assert got.numpy().tobytes() == want.numpy().tobytes(), k


def test_grow_kernel_is_the_card_level_path_and_refuses_larger_fits(cuda):
    """gbt_grow and the level-by-level launches give the same state; the
    kernel's own count of its shared memory is ``ops.grow_smem_bytes``'s
    for every cluster, and its plan takes a cluster whose block holds the
    fit (on an H100, whose SMs hold 2 blocks of 128 registers: the
    registry's 114 problems in clusters of 2 blocks, all resident); a fit
    beyond a block's shared memory raises on the card."""
    from repro_torch.core import gbt
    from repro_torch.kernels.gbt_hist import kernel
    c = fit_case(9, 4, 300, 5, 32, distinct=6)
    one, levels = (fit_state(c, 5, 5, cuda) for _ in range(2))
    gh_ops.grow_fit(one, 5, 5, 32, 1.0, 1.0, 0.1)
    gbt._grow_levels(levels, 5, 5, 32, 1.0, 1.0, 0.1)
    for k in GROW_STATE:
        assert torch.equal(getattr(one, k), getattr(levels, k)), k
    for L, n, f, n_bins, d in ((3, 48, 7, 64, 4), (114, 16, 7, 64, 4),
                               (1, 125, 24, 4, 4), (1, 3360, 3, 64, 6),
                               (2, 40, 9, 16, 8), (300, 20, 7, 16, 3)):
        for most in range(1, min(f, 8) + 1):
            assert kernel.grow_smem_bytes(n, f, n_bins, d, most) == \
                gh_ops.grow_smem_bytes(n, f, n_bins, d, most)
        most, smem = kernel.grow_plan(L, n, f, n_bins, d)
        assert smem == gh_ops.grow_smem_bytes(n, f, n_bins, d, most) \
            <= gh_ops.GROW_SMEM
    assert gh_ops.grow_split(7, kernel.grow_plan(114, 16, 7, 64, 4)[0]) \
        == (4, 2)
    big = fit_case(1, 1, 11_088, 3, 64, distinct=8)
    with pytest.raises(ValueError, match="level by level"):
        gh_ops.grow_fit(fit_state(big, 1, 6, cuda), 1, 6, 64, 1.0, 1.0, 0.1)


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


def test_small_ala_grows_each_fit_in_one_launch(cuda):
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
    splits = gh_ops.split_level.launches
    grows = gh_ops.grow_fit.launches
    levels = gbt._joint_histograms.levels
    fits = gbt.grow_forests.fits
    ala.fit(*train.workload)
    ala.explore(test.workload, n_chains=2)
    ala.fit_error(n_estimators=10)
    err, conf = ala.estimate(test.workload)
    assert np.isfinite(err) and 0.0 < conf <= 1.0 + 1e-6
    assert gbt._joint_histograms.levels == levels   # no host loop
    # every fit on the card is one gbt_grow launch; no level launches
    assert gh_ops.grow_fit.launches - grows == gbt.grow_forests.fits - fits > 0
    assert gh_ops.build_node_histograms.launches == launches
    assert gh_ops.split_level.launches == splits


# -- the shapes of the four newer dense configs and Alg 4 ------------------
@pytest.mark.parametrize("d", [64, 128, 768, 1024, 3072, 5120, 8192])
@pytest.mark.parametrize("rows", [8, 300])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernels_at_the_served_widths(cuda, d, rows, dtype):
    """K1 plain and fused at every width the five dense configs serve
    (d_model 1024 to 8192, and qwen3's q/k norms over rows of d_head
    128); the fused sum bit for bit ``x + r``."""
    gen = torch.Generator(cuda).manual_seed(d)
    x, r = (_randn(gen, (rows, d), dtype, cuda) for _ in range(2))
    scale = _randn(gen, (d,), torch.float32, cuda)
    torch.testing.assert_close(rms_ops.rmsnorm(x, scale),
                               rmsnorm_ref(x, scale), **_tol(dtype))
    (s, y), (s_want, y_want) = (rms_ops.add_rmsnorm(x, r, scale),
                                add_rmsnorm_ref(x, r, scale))
    assert torch.equal(s, s_want)
    torch.testing.assert_close(y, y_want, **_tol(dtype))


@pytest.mark.parametrize("g", [2, 3, 5, 8])
@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_at_other_groups(cuda, g, b, dtype):
    """K3 at the GQA groups of qwen3 (16/8), llama3.2 (24/8), qwen2.5
    (40/8) and command-r (64/8): groups 3 and 5 leave MMA rows empty, 8
    fills a block."""
    gen = torch.Generator(cuda).manual_seed(g)
    h, kv, t, dh = 8 * g, 8, 576, 128
    q = _randn(gen, (b, h, dh), dtype, cuda)
    k = _randn(gen, (b, t, kv, dh), dtype, cuda)
    v = _randn(gen, (b, t, kv, dh), dtype, cuda)
    for pos in (0, 63, 300, t - 1):
        got = da_ops.decode_attention(q, k, v, pos)
        want = decode_attention_ref(q.reshape(b, kv, g, dh), k.transpose(1, 2),
                                    v.transpose(1, 2), pos).reshape(b, h, dh)
        torch.testing.assert_close(got, want, **_tol(dtype))


def test_decode_attention_graph_at_group_3(cuda):
    """One K3 launch at 24/8 heads captured and replayed at positions
    across its splits, bit-equal to the eager call at each."""
    gen = torch.Generator(cuda).manual_seed(3)
    b, h, kv, t, dh = 1, 24, 8, 2080, 128
    q = _randn(gen, (b, h, dh), torch.bfloat16, cuda)
    k = _randn(gen, (b, t, kv, dh), torch.bfloat16, cuda)
    v = _randn(gen, (b, t, kv, dh), torch.bfloat16, cuda)
    pos_t = torch.zeros(1, dtype=torch.int64, device=cuda)
    da_ops.decode_attention(q, k, v, pos_t)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = da_ops.decode_attention(q, k, v, pos_t)
    for pos in (0, 64, 319, 1000, 2079):
        pos_t.fill_(pos)
        graph.replay()
        assert torch.equal(out, da_ops.decode_attention(q, k, v, pos)), pos


def test_qwen3_decode_graph_lists_its_qk_norms(cuda):
    """qwen3's captured step holds one K1 a norm: two a block, the final
    one, and its q and k norms (two more a block)."""
    from repro_torch.inference.engine import DecodeGraph
    cfg = get_smoke_config("qwen3-0.6b").scaled(compute_dtype=torch.bfloat16)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    names = DecodeGraph(model, 2, 24).kernel_names()
    assert sum("rmsnorm" in n for n in names) == 4 * cfg.n_layers + 1
    assert sum("decode_attn" in n for n in names) == cfg.n_layers


def _two_hardware_rows():
    """Saturating rows of one model on two registered accelerators."""
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.expmodel import exp_model
    rng = np.random.default_rng(0)
    bbs = np.array([1, 2, 4, 8, 16, 32, 64], float)
    rows = []
    for acc, cap in (("tpu-v5e", 4000.0), ("gpu-h100-sxm", 9000.0)):
        for ii in (128.0, 512.0, 1024.0):
            for oo in (128.0, 256.0):
                for bb, t in zip(bbs, exp_model(bbs, 0.9 * cap, 0.08, cap)):
                    rows.append(dict(model="m", acc=acc, acc_count=1,
                                     back="f", prec="bf16", mode="serve",
                                     ii=ii, oo=oo, bb=bb,
                                     thpt=t * rng.normal(1.0, 0.01)))
    return Dataset.from_rows(rows)


def test_registry_fit_is_one_batched_fit_on_the_card(cuda):
    """Both combinations' Alg 2 in one LM solve (one padding class) and
    their Alg 3 in one ``grow_forests``: n_estimators x (max_depth + 1)
    levels, all in one ``gbt_grow`` launch."""
    from repro_torch.core import fit, gbt
    from repro_torch.core.registry import ModelRegistry
    data = _two_hardware_rows()
    counts = (fit._solve_padded.solves, gbt.grow_forests.levels,
              gh_ops.grow_fit.launches, gh_ops.build_node_histograms.launches,
              gh_ops.split_level.launches, gbt._joint_histograms.levels)
    reg = ModelRegistry().fit(data, n_estimators=12, max_depth=3)
    assert len(reg.combos) == 2
    assert (fit._solve_padded.solves - counts[0],
            gbt.grow_forests.levels - counts[1],
            gh_ops.grow_fit.launches - counts[2],
            gh_ops.build_node_histograms.launches - counts[3],
            gh_ops.split_level.launches - counts[4],
            gbt._joint_histograms.levels - counts[5]) == (1, 48, 1, 0, 0, 0)


def test_registry_on_the_card_matches_the_cpu(cuda):
    """The card's databases within the LM contract of the CPU's (curves
    1e-3 relative), its Alg 3 trees on the CPU's databases equal to the
    host loop's over K4's plain histograms, predictions within 1e-3."""
    from repro_torch.core.database import db_predict
    from repro_torch.core.predictor import train_param_predictors
    from repro_torch.core.registry import ModelRegistry
    data = _two_hardware_rows()
    card = ModelRegistry().fit(data, n_estimators=12)
    cpu = ModelRegistry(device="cpu").fit(data, n_estimators=12)
    assert list(card.combos) == list(cpu.combos)
    for combo, cm in cpu.combos.items():
        for key in cm.db.params:
            x = np.array([1.0, 8.0, 64.0])
            np.testing.assert_allclose(db_predict(card.combos[combo].db,
                                                  *key, x),
                                       db_predict(cm.db, *key, x), rtol=1e-3)
    trainings = [cm.db.training for cm in cpu.combos.values()]
    got = train_param_predictors(trainings, n_estimators=12)
    want = train_param_predictors(trainings, device="cpu", use_kernel=True,
                                  n_estimators=12)
    for a, b in zip(got, want):
        for ma, mb in zip(a.models, b.models):
            for ta, tb in zip(ma.trees_, mb.trees_):
                for k in ("feature", "threshold", "left", "right", "value"):
                    assert np.array_equal(getattr(ta, k), getattr(tb, k)), k
    np.testing.assert_allclose(card.predict(data), cpu.predict(data),
                               rtol=1e-3)


# ------------------------------------------- MoE and recurrent blocks -----
MOE_AND_RECURRENT = {"phi3.5-moe-42b-a6.6b": 32,
                     "llama4-maverick-400b-a17b": 32, "xlstm-125m": 32,
                     "jamba-1.5-large-398b": 32}


@pytest.mark.parametrize("arch", list(MOE_AND_RECURRENT))
def test_moe_and_recurrent_smoke_models_on_card_match_cpu(cuda, arch):
    """fp32 smoke models (routing, capacity, recurrent states) on the card
    against the same weights on the CPU, prefill and 3 decode steps."""
    cfg = get_smoke_config(arch).scaled(compute_dtype=torch.float32)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    cpu = Model(cfg).load({n: p.cpu() for n, p in model.named_parameters()})
    s = MOE_AND_RECURRENT[arch]
    toks = torch.randint(0, cfg.vocab_size, (2, s),
                         generator=torch.Generator().manual_seed(1))
    got, gcache = model.prefill(toks.to(cuda), s + 3)
    want, ccache = cpu.prefill(toks, s + 3)
    torch.testing.assert_close(got.cpu(), want, **_tol(torch.float32))
    for tok in toks[:, :3].T[:, :, None]:
        got, gcache = model.decode_step(gcache, tok.to(cuda))
        want, ccache = cpu.decode_step(ccache, tok)
        torch.testing.assert_close(got.cpu(), want, **_tol(torch.float32))
    for st, ref in zip(gcache.blocks, ccache.blocks):
        for a, b in zip(st, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", list(MOE_AND_RECURRENT))
def test_moe_and_recurrent_decode_graphs_are_the_eager_steps(cuda, arch):
    """bf16 smoke models: an eager decode step syncs no value to the host
    (``set_sync_debug_mode("error")``), and 16 replays of the captured
    step equal 16 eager greedy steps bit for bit, logits, tokens and every
    recurrent state."""
    from repro_torch.inference.engine import DecodeGraph
    from repro_torch.inference.sampling import sample
    cfg = get_smoke_config(arch)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    s = MOE_AND_RECURRENT[arch]
    toks = torch.randint(0, cfg.vocab_size, (3, s), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(4))
    graph = DecodeGraph(model, 3, s + 20)
    logits, cache = model.prefill(toks, s + 20)
    tok = sample(logits, vocab_size=cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(cache, tok)
        tok = sample(logits, vocab_size=cfg.vocab_size)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [(logits.clone(), tok)]
    for _ in range(15):
        logits, cache = model.decode_step(cache, tok)
        tok = sample(logits, vocab_size=cfg.vocab_size)
        want.append((logits.clone(), tok))
    logits, _ = model.prefill(toks, cache=graph.cache)
    graph.start(sample(logits, vocab_size=cfg.vocab_size))
    for i, (wl, wt) in enumerate(want):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.logits, wl), i
        assert torch.equal(graph.tok, wt), i
    assert int(graph.cache.pos_t) == s + 16
    for st, ref in zip(graph.cache.blocks, cache.blocks):
        if type(st).__name__ != "KVCache":
            assert all(torch.equal(a, b) for a, b in zip(st, ref))


# ------------------------- encoder-decoder and vision paths (whisper, ----
# ------------------------- internvl2): K2's own key length, K3 over the --
# ------------------------- encoder's frames, K1 at d 896, the models -----
ENCDEC_HEADS = [(16, 16), (14, 2)]   # whisper G 1, internvl2 G 7


@pytest.mark.parametrize("sq,sk", [(1, 1500), (16, 1500), (128, 1500),
                                   (300, 65), (64, 63), (128, 64)])
@pytest.mark.parametrize("h,kv", ENCDEC_HEADS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_kernel_takes_a_key_length_of_its_own(
        cuda, sq, sk, h, kv, causal, dtype):
    """K2 with Sq query rows against Sk keys (whisper's 1,500 frames,
    ragged against the 64-key tiles, and around one tile), causal as the
    top-left mask row >= col, at Dh 64."""
    gen = torch.Generator(cuda).manual_seed(11)
    q = _randn(gen, (2, sq, h, 64), dtype, cuda)
    k = _randn(gen, (2, sk, kv, 64), dtype, cuda)
    v = _randn(gen, (2, sk, kv, 64), dtype, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _flash_want(q, k, v, causal),
                               **_tol(dtype))


@pytest.mark.parametrize("sq,sk", [(16, 1500), (300, 65), (1500, 1500)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_kernel_matches_its_emulation_at_its_own_sk(
        cuda, sq, sk, causal):
    """K2's bf16 output within one bf16 ulp of its emulated rounding points
    at Sq != Sk and at whisper's encoder length (the 1,500 tail), G 1."""
    gen = torch.Generator(cuda).manual_seed(12)
    q = _randn(gen, (1, sq, 4, 64), torch.bfloat16, cuda)
    k = _randn(gen, (1, sk, 4, 64), torch.bfloat16, cuda)
    v = _randn(gen, (1, sk, 4, 64), torch.bfloat16, cuda)
    got = fa_ops.flash_attention(q, k, v, causal=causal).cpu().float()
    want = attention_bf16_emulated(q.cpu(), k.cpu(), v.cpu(), causal=causal)
    err = (got - want.float()).abs() / _bf16_ulp(want)
    assert err.max() <= 1, f"{err.max():.3g} ulp"


@pytest.mark.parametrize("sq,sk", [(65, 1500), (129, 70)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_own_sk_reads_only_its_views(cuda, sq, sk, causal,
                                                     dtype):
    """q and k/v strided views of buffers of other lengths, NaN around
    them: a read past Sq or Sk reaches the output."""
    gen = torch.Generator(cuda).manual_seed(13)
    qbuf = torch.full((2, sq + 5, 10, 80), float("nan"), dtype=dtype,
                      device=cuda)
    kbuf = torch.full((2, sk + 7, 6, 80), float("nan"), dtype=dtype,
                      device=cuda)
    q = qbuf[:, 2:2 + sq, 1:9, 8:72]
    k, v = kbuf[:, 3:3 + sk, 0:2, 8:72], kbuf[:, 3:3 + sk, 3:5, 8:72]
    for x in (q, k, v):
        x.copy_(_randn(gen, x.shape, dtype, cuda))
    got = fa_ops.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _flash_want(q, k, v, causal),
                               **_tol(dtype))


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("h,kv", ENCDEC_HEADS)
@pytest.mark.parametrize("pos", [0, 700, 1499])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_attention_kernel_over_the_encoder_frames(cuda, b, h, kv, pos,
                                                         dtype):
    """K3 over a 1,500-slot cache at G 1 and G 7; pos 1499 is whisper's
    cross attention in a decode step, read from a device tensor."""
    gen = torch.Generator(cuda).manual_seed(14)
    q = _randn(gen, (b, h, 64), dtype, cuda)
    k = _randn(gen, (b, 1500, kv, 64), dtype, cuda)
    v = _randn(gen, (b, 1500, kv, 64), dtype, cuda)
    pos_t = torch.full((1,), pos, dtype=torch.int64, device=cuda)
    got = da_ops.decode_attention(q, k, v, pos_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, _decode_want(q, k, v, pos),
                               **_tol(dtype))


@pytest.mark.parametrize("rows", [8, 2048])
@pytest.mark.parametrize("dtype", DTYPES)
def test_rmsnorm_kernels_at_internvl2_width(cuda, rows, dtype):
    """K1 plain and fused at d 896 (112 16-byte vectors a bf16 row)."""
    gen = torch.Generator(cuda).manual_seed(15)
    x, r = (_randn(gen, (rows, 896), dtype, cuda) for _ in range(2))
    scale = _randn(gen, (896,), torch.float32, cuda)
    torch.testing.assert_close(rms_ops.rmsnorm(x, scale),
                               rmsnorm_ref(x, scale), **_tol(dtype))
    s, y = rms_ops.add_rmsnorm(x, r, scale)
    want_s, want_y = add_rmsnorm_ref(x, r, scale)
    assert torch.equal(s, want_s)
    torch.testing.assert_close(y, want_y, **_tol(dtype))


def _frontend(cfg, b, text, device, seed=1):
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import io
    seq = text + (cfg.n_patches if cfg.frontend == "vision" else 0)
    batch = io.make_batch(cfg, ShapeSpec("p", seq, b, "prefill"), seed,
                          device)
    return batch.pop("tokens").long(), batch, seq


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_encdec_and_vision_smoke_models_on_card_match_cpu(cuda, arch):
    """fp32 smoke models on the card against the same weights on the CPU,
    prefill and 3 decode steps: logits, self K/V and whisper's cross K/V."""
    cfg = get_smoke_config(arch).scaled(compute_dtype=torch.float32)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    cpu = Model(cfg).load({n: p.cpu() for n, p in model.named_parameters()})
    toks, extra, seq = _frontend(cfg, 2, 24, "cpu")
    got, gcache = model.prefill(toks.to(cuda), seq + 3,
                                **{k: t.to(cuda) for k, t in extra.items()})
    want, ccache = cpu.prefill(toks, seq + 3, **extra)
    torch.testing.assert_close(got.cpu(), want, **_tol(torch.float32))
    for tok in toks[:, :3].T[:, :, None]:
        got, gcache = model.decode_step(gcache, tok.to(cuda))
        want, ccache = cpu.decode_step(ccache, tok)
        torch.testing.assert_close(got.cpu(), want, **_tol(torch.float32))
    for st, ref in zip(gcache.blocks + (gcache.cross or ()),
                       ccache.blocks + (ccache.cross or ())):
        for a, b in zip(st, ref):
            torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_encdec_and_vision_decode_graphs_are_the_eager_steps(cuda, arch):
    """bf16 smoke models: an eager decode step (cross attention included)
    syncs no value to the host, and 16 replays of the captured step equal
    16 eager greedy steps bit for bit, with the cross K/V the prefill
    wrote into the graph's own buffers."""
    from repro_torch.inference.engine import DecodeGraph
    from repro_torch.inference.sampling import sample
    cfg = get_smoke_config(arch)
    model = Model(cfg).init(torch.Generator(cuda).manual_seed(0))
    toks, extra, seq = _frontend(cfg, 3, 20, cuda, seed=4)
    graph = DecodeGraph(model, 3, seq + 20)
    logits, cache = model.prefill(toks, seq + 20, **extra)
    tok = sample(logits, vocab_size=cfg.vocab_size)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits, cache = model.decode_step(cache, tok)
        tok = sample(logits, vocab_size=cfg.vocab_size)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = [(logits.clone(), tok)]
    for _ in range(15):
        logits, cache = model.decode_step(cache, tok)
        tok = sample(logits, vocab_size=cfg.vocab_size)
        want.append((logits.clone(), tok))
    logits, _ = model.prefill(toks, cache=graph.cache, **extra)
    graph.start(sample(logits, vocab_size=cfg.vocab_size))
    for i, (wl, wt) in enumerate(want):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(graph.logits, wl), i
        assert torch.equal(graph.tok, wt), i
    assert int(graph.cache.pos_t) == seq + 16
    for st, ref in zip(graph.cache.cross or (), cache.cross or ()):
        assert all(torch.equal(a, b) for a, b in zip(st, ref))


def _serving_trace(horizon_s):
    from repro_torch.serving.traces import (FleetTraceConfig, TenantConfig,
                                            TraceConfig, make_fleet_trace,
                                            mix)
    return make_fleet_trace(FleetTraceConfig(tenants=(
        TenantConfig(name="chat", trace=TraceConfig(
            arrival="poisson", rate=12.0, shape_mix=mix(("chat", 1.0))),
            diurnal_amp=0.4, diurnal_period_s=60.0),
        TenantConfig(name="generate", trace=TraceConfig(
            arrival="mmpp", rate=4.0, burst_rate=10.0,
            shape_mix=mix(("generate", 1.0))), flash_crowds=2,
            flash_mult=3.0, flash_dur_s=8.0),
    ), horizon_s=horizon_s, seed=7))


@pytest.mark.parametrize("arch,hw,chips", [
    ("llama3.1-8b", "tpu-v5e", 4),
    ("llama4-maverick-400b-a17b", "gpu-mi300x", 8)])
def test_fleet_trajectories_on_the_card_equal_numpy(cuda, arch, hw, chips):
    """The fleet engine's ``traj_backend="torch"`` on the card against
    ``"numpy"`` on a seeded trace with crashes and stragglers: a dense
    config bit for bit in every array; llama4-maverick (MoE: the device's
    ``pow`` in the expert-hit term) with the same accounting and events
    and every time within 1e-9 s."""
    from repro_torch.configs import get_config
    from repro_torch.perfmodel.hardware import PROFILES
    from repro_torch.perfmodel.simulator import ServingSetup
    from repro_torch.serving.faults import FaultConfig, injector
    from repro_torch.serving.simulator import SimConfig, simulate
    tr = _serving_trace(120.0)
    setup = ServingSetup(get_config(arch), PROFILES[hw], chips=chips)

    def run(backend):
        return simulate(tr, SimConfig(
            setup=setup, n_replicas=3, bucket_s=0.25, traj_backend=backend,
            faults=injector(FaultConfig(seed=2, horizon_s=120.0,
                                        n_replicas=3, mttf_s=40.0,
                                        straggler_rate_hz=0.05)),
            max_retries=1), engine="fleet")

    want, got = run("numpy"), run("torch")
    assert got.accounting() == want.accounting()
    assert want.accounting()["completed"] > 500
    assert got.n_events == want.n_events
    moe = arch.startswith("llama4")
    for k in want.req:
        a, b = got.req[k], want.req[k]
        if b.dtype == object:
            assert a.tolist() == b.tolist(), k
        elif moe and b.dtype == np.float64:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-9)
        else:
            assert a.tobytes() == b.tobytes(), k


def test_fleet_torch_trajectories_without_a_card_raise(monkeypatch):
    """``traj_backend="torch"`` means the card unless the caller asks for
    the CPU: with no CUDA device it raises and never runs on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.perfmodel.hardware import TPU_V5E
    from repro_torch.perfmodel.simulator import ServingSetup
    from repro_torch.serving.fleet import VectorFleetSimulator
    from repro_torch.serving.simulator import SimConfig
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = SimConfig(setup=ServingSetup(get_config("llama3.1-8b"), TPU_V5E),
                    traj_backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VectorFleetSimulator(_serving_trace(10.0), cfg)


def test_traced_fleet_on_the_card_gives_numpys_spans(cuda):
    """The observability hook on the card's trajectories: a traced,
    step-capped fleet run with crashes and stragglers, its span table
    equal to the numpy run's in every column and its capped step log,
    dropped counts and lossless totals equal too."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.obs import ObsConfig
    from repro_torch.obs.tracing import SpanTable
    from repro_torch.perfmodel.hardware import TPU_V5E
    from repro_torch.perfmodel.simulator import ServingSetup
    from repro_torch.serving.faults import FaultConfig, injector
    from repro_torch.serving.simulator import SimConfig, simulate
    tr = _serving_trace(120.0)
    setup = ServingSetup(get_config("llama3.1-8b"), TPU_V5E, chips=4)

    def run(backend):
        return simulate(tr, SimConfig(
            setup=setup, n_replicas=3, bucket_s=0.25, traj_backend=backend,
            faults=injector(FaultConfig(seed=2, horizon_s=120.0,
                                        n_replicas=3, mttf_s=40.0,
                                        straggler_rate_hz=0.05)),
            max_retries=1, obs=ObsConfig(max_steps=2000,
                                         max_fault_events=4)),
            engine="fleet")

    want, got = run("numpy"), run("torch")
    assert got.spans.n == want.spans.n == len(tr)
    for f in dataclasses.fields(SpanTable):
        a, b = getattr(got.spans, f.name), getattr(want.spans, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, f.name
            assert (a.tolist() == b.tolist() if b.dtype == object
                    else a.tobytes() == b.tobytes()), f.name
        else:
            assert a == b, f.name
    assert got.steps_dropped == want.steps_dropped > 0
    assert got.faults_dropped == want.faults_dropped > 0
    assert got.step_totals == want.step_totals
    for k in want.step_arrays:
        assert len(got.step_arrays[k]) == 2000
        assert got.step_arrays[k].tobytes() == want.step_arrays[k].tobytes()


def test_audited_online_refits_grow_each_fit_in_one_launch(cuda):
    """``OnlineALA(audit=...)`` on the card: every ingest lands in the
    audit as a refit event, and every fit of the refits is one
    ``gbt_grow`` launch, with no launch a level and no host loop."""
    from repro_torch.core import gbt
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.online import OnlineALA, OnlineConfig
    from repro_torch.obs import CalibrationAudit

    def rows(n, seed, scale=1.0):
        r = np.random.default_rng(seed)
        ii, oo = r.choice([128, 256, 512, 1024], n), r.choice([64, 256], n)
        bb = r.choice([1, 2, 4, 8, 16, 32, 64], n)
        thpt = (scale * 5000 * (1 - np.exp(-0.05 * bb)) * (512 / ii) ** 0.3
                * r.lognormal(0, 0.03, n))
        return Dataset.from_rows([
            dict(model="m-a", acc="tpu-v5e", acc_count=4, back="sim-trace",
                 prec="bf16", mode="serve", ii=int(a), oo=int(b), bb=int(c),
                 thpt=float(t)) for a, b, c, t in zip(ii, oo, bb, thpt)])

    sa = SAConfig(n_iters=4, n_chains=2, seed=0,
                  gbt_kw=dict(n_estimators=15, learning_rate=0.2,
                              max_depth=3))
    audit = CalibrationAudit()
    eng = OnlineALA(OnlineConfig(sa=sa, warm_iters=3, gbt_kw=dict(sa.gbt_kw)),
                    audit=audit)
    grows, fits = gh_ops.grow_fit.launches, gbt.grow_forests.fits
    hists, splits = (gh_ops.build_node_histograms.launches,
                     gh_ops.split_level.launches)
    levels = gbt._joint_histograms.levels
    eng.ingest(rows(50, 1), n_estimators=10)
    eng.ingest(rows(15, 3, scale=0.25), n_estimators=10)
    assert audit.counts["refit"] == 2
    assert [e.data["n_refit"] for e in audit.events if e.kind == "refit"] \
        == [1, 1]
    assert gh_ops.grow_fit.launches - grows == \
        gbt.grow_forests.fits - fits > 0
    assert gh_ops.build_node_histograms.launches == hists
    assert gh_ops.split_level.launches == splits
    assert gbt._joint_histograms.levels == levels


# ------------------------------------------------------------- training --
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (40, 96),
                                   (4096, 1024), (8192, 4096), (5000, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_rmsnorm_bwd_kernel(cuda, shape, dtype, fused):
    """K1's backward against its plain version (dx, and dscale summed over
    the rows), and bit-equal over two runs: no float atomics.  dscale is
    held by the norm of its error: it sums up to 8,192 terms of order one
    in fp32, so an element that cancels to near zero carries the
    summation order's error (4e-5 at 8,192 x 4,096, relative 2e-4 to
    that element)."""
    gen = torch.Generator(cuda).manual_seed(11)
    x, dy = (_randn(gen, shape, dtype, cuda) for _ in range(2))
    ds = _randn(gen, shape, dtype, cuda) if fused else None
    scale = 1 + 0.1 * _randn(gen, shape[-1:], torch.float32, cuda)
    n = rms_ops.rmsnorm_bwd.launches
    dx, dscale = rms_ops.rmsnorm_bwd(x, scale, dy, ds)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm_bwd.launches == n + 1
    want = (add_rmsnorm_bwd_ref(x, scale, dy, ds) if fused
            else rmsnorm_bwd_ref(x, scale, dy))
    assert dx.dtype == dtype and dscale.dtype == torch.float32
    torch.testing.assert_close(dx, want[0], **_tol(dtype))
    assert (dscale - want[1]).norm() <= _tol(dtype)["rtol"] * want[1].norm()
    again = rms_ops.rmsnorm_bwd(x, scale, dy, ds)
    assert torch.equal(dx, again[0]) and torch.equal(dscale, again[1])


# (B, Sq, Sk, H, KV, Dh, causal) of K2's backward: the first eight since
# the kernel was written; then the edges of its 128-row blocks and 64-row
# streamed tiles: one query row (causal and against 70 keys), fewer than 64
# keys, lengths off both multiples, G 4 and G 7 (internvl2's 14/2 heads),
# Dh 16 and 32, and a call with no query row (S 0), whose dK and dV are 0
BWD_CASES = [
    (1, 128, 128, 4, 4, 64, True), (2, 256, 256, 8, 2, 128, True),
    (2, 65, 65, 4, 2, 16, True), (1, 129, 129, 6, 2, 32, False),
    (2, 1000, 1000, 8, 8, 64, False), (2, 100, 300, 4, 4, 64, False),
    (1, 300, 100, 4, 2, 128, True), (1, 512, 1500, 16, 16, 64, False),
    (2, 1, 1, 4, 1, 64, True), (1, 1, 70, 4, 2, 128, False),
    (2, 40, 50, 8, 2, 128, True), (1, 200, 333, 14, 2, 64, True),
    (1, 333, 200, 8, 2, 32, False), (2, 190, 190, 14, 2, 64, True),
    (1, 300, 300, 16, 4, 128, True), (1, 77, 77, 4, 1, 16, False),
    (2, 0, 20, 4, 2, 64, True), (1, 0, 130, 14, 2, 128, False)]


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal", BWD_CASES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_bwd_kernel(cuda, b, sq, sk, h, kv, dh, causal,
                                    dtype):
    """K2's backward (dq, dk, dv) against its plain version, from the
    forward's output and LSE (the LSE against the plain one), bit-equal
    over two runs; also through autograd on q, k, v.  With no query row
    the call launches nothing and dK and dV are zeros, not the stale
    contents of reused memory (the allocator is handed NaN first)."""
    gen = torch.Generator(cuda).manual_seed(12)
    q = _randn(gen, (b, sq, h, dh), dtype, cuda)
    k, v = (_randn(gen, (b, sk, kv, dh), dtype, cuda) for _ in range(2))
    dout = _randn(gen, (b, sq, h, dh), dtype, cuda)
    out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
    hm = [t.transpose(1, 2) for t in (q, k, v, out, dout)]
    torch.testing.assert_close(
        lse, attention_ref(*hm[:3], causal=causal, return_lse=True)[1],
        **_tol(dtype))
    stale = torch.full((4 * k.numel(),), float("nan"), dtype=dtype,
                       device=cuda)
    del stale
    n = fa_ops.flash_attention_bwd.launches
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches == n + (sq > 0)
    if sq == 0:
        assert got[0].shape == q.shape
        assert all(torch.equal(g, torch.zeros_like(t))
                   for g, t in zip(got[1:], (k, v)))
    want = attention_bwd_ref(*hm, causal=causal)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w.transpose(1, 2), **_tol(dtype))
    again = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    fa_ops.flash_attention(*leaves, causal=causal).backward(dout)
    for leaf, g in zip(leaves, got):
        assert torch.equal(leaf.grad, g)


@pytest.mark.parametrize("b,sq,sk,h,kv,dh,causal", [
    (2, 256, 256, 8, 2, 128, True), (1, 300, 300, 8, 2, 128, True),
    (2, 190, 190, 14, 2, 64, True), (1, 333, 200, 8, 2, 32, False),
    (2, 100, 300, 4, 4, 64, False), (1, 77, 77, 4, 1, 16, False),
    (1, 1, 70, 4, 2, 128, False)])
def test_flash_attention_bwd_bf16_kernel_matches_its_emulation(
        cuda, b, sq, sk, h, kv, dh, causal):
    """K2's bf16 backward against ``attention_bwd_bf16_emulated``, its
    rounding points in plain torch, computed on the card in fp32 from the
    same inputs and LSE (``test_torch_attention_bwd_emulated.py`` holds
    that emulation to JAX's gradient of ``_sdpa``): within one bf16 ulp
    (floored at 1/16, as the forward's check) but for at most 0.1% of the
    elements, which stay within 8.  The kernel's ex2.approx and its fp32
    sums' order flip the bf16 rounding of a few P or dS elements, each
    moving its sums by an ulp of that term, and a sum that cancels (dS
    sums to 0 over a row) makes that several ulps of the result; the
    first case, B 2, S 256, G 4, Dh 128, shows it."""
    gen = torch.Generator(cuda).manual_seed(13)
    q = _randn(gen, (b, sq, h, dh), torch.bfloat16, cuda)
    k, v = (_randn(gen, (b, sk, kv, dh), torch.bfloat16, cuda)
            for _ in range(2))
    dout = _randn(gen, (b, sq, h, dh), torch.bfloat16, cuda)
    out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
    got = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    want = attention_bwd_bf16_emulated(q, k, v, out, lse, dout,
                                       causal=causal)
    for g, w in zip(got, want):
        err = (g.float() - w.float()).abs() / _bf16_ulp(w)
        assert err.max() <= 8, f"{err.max():.3g} ulp"
        assert (err > 1).float().mean() <= 1e-3, \
            f"{(err > 1).float().mean():.3g} of the elements beyond one ulp"


def test_flash_attention_bwd_bf16_kernels_use_wgmma_without_spills(cuda):
    """Every bf16 instantiation of K2's dK/dV and dQ kernels holds HGMMA
    (wgmma) instructions in its SASS (``cuobjdump -sass`` of the built
    library) and spills no register (its ptxas report)."""
    from repro_torch.kernels import _build
    kinds = _build.tensor_core_kinds("flash_attention_bwd")
    report = _build.ptxas_report("flash_attention_bwd")
    bf16 = [k for k in kinds if "_bf16" in k]
    assert len(bf16) == 2 * len(_build.HEAD_DIMS), sorted(kinds)
    assert all(kinds[k]["HGMMA"] > 0 for k in bf16), kinds
    assert all(report[k][1] == 0 for k in bf16), report


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "whisper-medium"])
def test_train_step_on_card_matches_cpu(cuda, arch, tmp_path):
    """One Trainer step of a smoke model in fp32 on the card against the
    CPU from the same parameters and batch: the loss within 1e-4, each
    gradient within 1e-3 of its norm; the step's K1 and K2 launches."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = get_smoke_config(arch).scaled(compute_dtype=torch.float32)
    shape = ShapeSpec("t", 64, 2, "train")
    tc = TrainConfig(ckpt_dir=str(tmp_path), opt=AdamWConfig(warmup_steps=2))
    cpu = Trainer(Model(cfg), shape, None, tc, device="cpu")
    card = Trainer(Model(cfg), shape, None, tc)
    params, opt = cpu.init_state(0)
    card.model.load({k: t.detach().to(cuda) for k, t in params.items()},
                    train=True)
    cparams = dict(card.model.named_parameters())
    before = (fa_ops.flash_attention.launches,
              fa_ops.flash_attention_bwd.launches,
              rms_ops.rmsnorm_bwd.launches)
    _, _, loss_cpu, _ = cpu.step(params, opt, cpu.batch(0))
    _, _, loss_card, _ = card.step(cparams, adamw_init(cparams),
                                   card.batch(0))
    n_attn = cfg.n_layers * (2 if cfg.is_encdec else 1) + cfg.n_encoder_layers
    fwd, bwd, k1 = (fa_ops.flash_attention.launches - before[0],
                    fa_ops.flash_attention_bwd.launches - before[1],
                    rms_ops.rmsnorm_bwd.launches - before[2])
    assert (fwd, bwd) == (n_attn, n_attn) and k1 > 0
    assert abs(float(loss_card) - float(loss_cpu)) <= 1e-4 * float(loss_cpu)
    for k, p in params.items():
        g = cparams[k].grad.cpu()
        assert (g - p.grad).norm() <= 1e-3 * p.grad.norm() + 1e-12, k


@pytest.fixture
def one_rank_mesh(cuda, tmp_path):
    """The (1, 1) ("data", "model") mesh over a one-rank NCCL group made
    from a FileStore (no TCP port), destroyed after the test."""
    import torch.distributed as dist
    from repro_torch.distributed.compat import init_device_mesh
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield init_device_mesh("cuda", (1, 1),
                               mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()


def test_constrain_outside_a_policy_is_the_same_object(cuda):
    from repro_torch.distributed.sharding import constrain, get_policy
    x = torch.zeros(8, 16, 64, device=cuda)
    assert get_policy() is None and constrain(x, "act_btd") is x


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernels_on_one_rank_dtensors_are_the_plain_calls(one_rank_mesh,
                                                          dtype):
    """K1 (plain and fused), K2 and K3 on DTensors placed as the policy
    places them (batch on ``data``, heads on ``model``) over one rank:
    the same bits as the calls on the plain tensors, one launch each."""
    from repro_torch.distributed.compat import (DTensor, Replicate, Shard,
                                                distribute_tensor)
    mesh, dev = one_rank_mesh, torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(27)

    def place(t, *pl):
        return distribute_tensor(t, mesh, pl)

    def launches():
        return (rms_ops.rmsnorm.launches, rms_ops.add_rmsnorm.launches,
                fa_ops.flash_attention.launches,
                da_ops.decode_attention.launches)

    x, r = (_randn(gen, (8, 64, 4096), dtype, dev) for _ in range(2))
    scale = _randn(gen, (4096,), torch.float32, dev)
    q = _randn(gen, (2, 256, 32, 128), dtype, dev)
    k, v = (_randn(gen, (2, 256, 8, 128), dtype, dev) for _ in range(2))
    qd = _randn(gen, (8, 32, 128), dtype, dev)
    kc, vc = (_randn(gen, (8, 576, 8, 128), dtype, dev) for _ in range(2))
    pos = torch.full((1,), 500, dtype=torch.int64, device=dev)
    rows, heads = (Shard(0), Replicate()), (Shard(0), Shard(2))
    before = launches()
    got = [rms_ops.rmsnorm(place(x, *rows), place(scale, Replicate(),
                                                  Replicate())),
           *rms_ops.add_rmsnorm(place(x, *rows), place(r, *rows), scale),
           fa_ops.flash_attention(place(q, *heads), place(k, *heads),
                                  place(v, *heads)),
           da_ops.decode_attention(place(qd, Shard(0), Shard(1)),
                                   place(kc, *heads), place(vc, *heads),
                                   pos)]
    assert [b - a for a, b in zip(before, launches())] == [1, 1, 1, 1]
    want = [rms_ops.rmsnorm(x, scale), *rms_ops.add_rmsnorm(x, r, scale),
            fa_ops.flash_attention(q, k, v),
            da_ops.decode_attention(qd, kc, vc, pos)]
    for g, w in zip(got, want):
        assert isinstance(g, DTensor)
        assert torch.equal(g.full_tensor(), w)
