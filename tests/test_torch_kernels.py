"""The torch kernels' plain versions (what the wrappers run on CPU tensors)
against the JAX kernels' ``ref.py`` and their Pallas kernels in interpret
mode, on the shape sweeps of ``test_kernels.py`` and at its tolerances:
fp32 2e-5, bf16 2e-2.  The CUDA kernels themselves run only on a card:
``test_torch_gpu.py`` and ``chip_smoke.py`` hold them to these plain
versions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as jda_ops
from repro.kernels.flash_attention import ops as jfa_ops
from repro.kernels.rmsnorm import ops as jrms_ops

from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.emulate import (
    decode_attention_split_emulated, kernel_splits)
from repro_torch.kernels.decode_attention.kernel import (TILE, cluster_size,
                                                        split_plan, splits_of)
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.emulate import attention_bf16_emulated
from repro_torch.kernels.rmsnorm import ops as rms_ops

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(dtype_name):
    return dict(rtol=2e-2, atol=2e-2) if dtype_name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, shapes, dtype_name):
    """The same seeded values as a JAX array and a torch tensor each."""
    jdt, tdt = _DTYPES[dtype_name]
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, dtype_name):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype_name))


# ---------------------------------------------------------------- rmsnorm --
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (17, 96)])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_rmsnorm_matches_jax(shape, dtype_name):
    (jx,), (tx,) = _inputs(0, [shape], dtype_name)
    scale = np.random.default_rng(1).standard_normal(shape[-1:])
    scale = scale.astype(np.float32)
    got = rms_ops.rmsnorm(tx, torch.from_numpy(scale))
    assert got.dtype == tx.dtype and got.shape == tx.shape
    for force in ("ref", "interpret"):
        _close(got, jrms_ops.rmsnorm(jx, jnp.asarray(scale), force=force,
                                     block_rows=8), dtype_name)


@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (1, 256), (17, 96)])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_add_rmsnorm_matches_jax(shape, dtype_name):
    """The fused entry's plain version: s is torch's ``x + r`` bit for bit,
    and y the JAX kernel's RMSNorm of JAX's ``x + r``."""
    (jx, jr), (tx, tr) = _inputs(10, [shape, shape], dtype_name)
    scale = np.random.default_rng(11).standard_normal(shape[-1:])
    scale = scale.astype(np.float32)
    s, y = rms_ops.add_rmsnorm(tx, tr, torch.from_numpy(scale))
    assert s.dtype == y.dtype == tx.dtype and s.shape == y.shape == tx.shape
    assert torch.equal(s.view(torch.uint8), (tx + tr).view(torch.uint8))
    _close(s, jx + jr, dtype_name)
    for force in ("ref", "interpret"):
        _close(y, jrms_ops.rmsnorm(jx + jr, jnp.asarray(scale), force=force,
                                   block_rows=8), dtype_name)


# ---------------------------------------------------------- flash attention --
@pytest.mark.parametrize("b,h,kv,s,dh", [
    (1, 4, 4, 128, 64),     # MHA
    (2, 8, 2, 256, 64),     # GQA 4x
    (1, 4, 1, 128, 128),    # MQA
    (2, 6, 2, 64, 32),      # heads not multiple of 4
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(b, h, kv, s, dh, causal, dtype_name):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        2, [(b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh)], dtype_name)
    got = fa_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for force in ("ref", "interpret"):
        _close(got, jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                            force=force, block_q=64,
                                            block_k=64), dtype_name)


@pytest.mark.parametrize("s,force", [(320, "interpret"), (300, "ref")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_rounding_points_match_jax(s, force, causal):
    """K2's bf16 arithmetic, emulated step for step in torch (bf16 P into
    P.V, fp32 scores and sums, 64-key tiles, log2 domain), stays within the
    bf16 tolerance of the JAX flash kernel at llama head width: Dh 128,
    GQA 4:1.  ``test_torch_gpu.py`` holds K2 itself to the emulation at
    about one bf16 ulp."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        8, [(1, s, 8, 128), (1, s, 2, 128), (1, s, 2, 128)], "bfloat16")
    got = attention_bf16_emulated(tq, tk, tv, causal=causal)
    block = dict(block_q=64, block_k=64) if force == "interpret" else {}
    _close(got, jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                        force=force, **block), "bfloat16")


@pytest.mark.parametrize("b,h,kv,s,sk,dh", [
    (1, 4, 4, 64, 192, 16),     # cross attention: keys longer than queries
    (2, 8, 2, 128, 64, 64),     # keys shorter, GQA 4x
    (1, 14, 2, 64, 320, 64),    # internvl2's 7 query heads a KV head
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_flash_attention_takes_a_key_length_of_its_own(b, h, kv, s, sk, dh,
                                                       causal, dtype_name):
    """K2 at Sq != Sk, as the TPU kernel takes it (``sk`` its own), at
    sizes its 64-row blocks divide: causal is the top-left mask
    row >= col, whatever Sk is; fp32 within 2e-5, bf16 2e-2."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        9, [(b, s, h, dh), (b, sk, kv, dh), (b, sk, kv, dh)], dtype_name)
    got = fa_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for force in ("ref", "interpret"):
        _close(got, jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                            force=force, block_q=64,
                                            block_k=64), dtype_name)


@pytest.mark.parametrize("s,sk,force", [(128, 320, "interpret"),
                                        (16, 1500, "ref"), (1, 1500, "ref")])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bf16_rounding_points_at_a_key_length_of_its_own(
        s, sk, force, causal):
    """K2's emulated bf16 arithmetic at Sq != Sk, up to whisper's 1,500
    encoder frames (ragged against the 64-key tiles), within the bf16
    tolerance of the JAX flash kernel, at whisper's head width (Dh 64,
    G 1)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        10, [(1, s, 4, 64), (1, sk, 4, 64), (1, sk, 4, 64)], "bfloat16")
    got = attention_bf16_emulated(tq, tk, tv, causal=causal)
    block = dict(block_q=64, block_k=64) if force == "interpret" else {}
    _close(got, jfa_ops.flash_attention(jq, jk, jv, causal=causal,
                                        force=force, **block), "bfloat16")


@pytest.mark.parametrize("kshape", [(2, 16, 2, 32), (1, 0, 2, 32),
                                    (1, 16, 3, 32), (1, 16, 2, 16)],
                         ids=["batch", "no keys", "heads", "head size"])
def test_flash_attention_rejects_keys_that_do_not_fit(kshape):
    _, (q, k) = _inputs(11, [(1, 8, 4, 32), kshape], "float32")
    with pytest.raises(ValueError, match="not"):
        fa_ops.flash_attention(q, k, k)


# ---------------------------------------------------------- decode attention --
@pytest.mark.parametrize("b,h,kv,t,dh", [
    (2, 8, 2, 128, 64),
    (1, 4, 4, 512, 128),
    (4, 16, 8, 256, 64),
])
@pytest.mark.parametrize("pos_frac", [0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_decode_attention_matches_jax(b, h, kv, t, dh, pos_frac, dtype_name):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(b, h, dh), (b, t, kv, dh), (b, t, kv, dh)], dtype_name)
    pos = int((t - 1) * pos_frac)
    got = da_ops.decode_attention(tq, tk, tv, pos)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for force in ("ref", "interpret"):
        _close(got, jda_ops.decode_attention(jq, jk, jv, jnp.int32(pos),
                                             force=force, block_t=64),
               dtype_name)


@pytest.mark.parametrize("pos,n_split", [
    (0, 1), (0, 4),                       # one valid row
    (255, 1), (255, 2), (255, 4),         # one, two and every tile a split
    (127, 2), (128, 2), (129, 2),         # around the 128-row boundary
    (63, 4), (64, 4), (65, 4),            # around a one-tile boundary
    (200, 3),                             # a short last split
])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_decode_attention_split_emulation_matches_jax(pos, n_split,
                                                      dtype_name):
    """K3's split-and-merge arithmetic (``decode_attention_split_emulated``)
    within the kernels' tolerance of the JAX flash-decoding kernel, in
    interpret mode with 64-position blocks and through its plain version.
    ``test_torch_gpu.py`` holds K3 to the emulation at its own n_split."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        9, [(2, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64)], dtype_name)
    got = decode_attention_split_emulated(tq, tk, tv, pos, n_split)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    for force in ("ref", "interpret"):
        _close(got, jda_ops.decode_attention(jq, jk, jv, jnp.int32(pos),
                                             force=force, block_t=64),
               dtype_name)


@pytest.mark.parametrize("b,kv,g,pos,sms,want", [
    (8, 8, 4, 575, 132, (1, 576)),     # the (512, 64, 8) cell's last step
    (32, 8, 4, 255, 132, (1, 256)),    # the (128, 128, 32) cell's
    (1, 8, 4, 2079, 132, (7, 320)),    # one sequence: a cluster of 7
    (2, 8, 4, 575, 132, (3, 192)),
    (1, 8, 4, 0, 132, (1, 64)),
])
def test_decode_attention_split_plan(b, kv, g, pos, sms, want):
    assert split_plan(b, kv, g, pos, sms) == want


def test_decode_attention_split_plan_covers_pos_in_whole_tiles():
    """Every split is whole tiles, none starts past pos, the last covers
    it; a cluster holds at most 8 splits, the splits add no block past one
    for every two SMs, and they reach at least half of what those limits
    allow."""
    for b in (1, 2, 3, 8, 32, 64):
        for g in (1, 4, 12):
            for pos in (0, 1, 63, 64, 65, 511, 575, 1024, 2079, 8191):
                for sms in (1, 78, 132):
                    n, rows = split_plan(b, 8, g, pos, sms)
                    assert rows % TILE == 0 and 1 <= n <= 8
                    assert (n - 1) * rows <= pos < n * rows
                    blocks = b * 8 * -(-g // 8)
                    assert blocks * n <= max(blocks, sms // 2)
                    allowed = min(pos // TILE + 1, 8,
                                  max(1, sms // (2 * blocks)))
                    assert 2 * n >= allowed


@pytest.mark.parametrize("n_split", range(1, 9))
def test_decode_attention_in_kernel_plan_is_splits_of(n_split):
    """The plan the kernel computes from the position in device memory
    (``emulate.kernel_splits``, its integer arithmetic) is ``splits_of`` at
    every position of a 4,096-slot cache, and clamps a position past it."""
    t = 4096
    for pos in range(t):
        assert kernel_splits(pos, n_split, t) == splits_of(pos, n_split), pos
    assert kernel_splits(t + 5, n_split, t) == splits_of(t - 1, n_split)


def test_decode_attention_grid_covers_the_splits_of_every_position():
    """The launch's split count (``cluster_size``), fixed for a cache,
    holds the plan's splits at every position of it, and equals the most
    of them: no launch changes with the position."""
    for b in (1, 2, 4, 8, 32):
        for t in (1, 64, 65, 130, 576, 2080):
            for sms in (78, 132):
                grid = cluster_size(b, 8, 4, t, sms)
                plans = [split_plan(b, 8, 4, p, sms)[0] for p in range(t)]
                assert max(plans) == grid and (grid - 1) * TILE < t


@pytest.mark.parametrize("pos", [0, 63, 64, 200, 255])
def test_decode_attention_takes_the_position_as_a_tensor(pos):
    """pos as a one-element int64 tensor (as the decode step passes it)
    gives what the int gives; other tensors are refused."""
    _, (q, k, v) = _inputs(12, [(2, 8, 64), (2, 256, 2, 64),
                                (2, 256, 2, 64)], "float32")
    got = da_ops.decode_attention(q, k, v, torch.tensor([pos]))
    assert torch.equal(got, da_ops.decode_attention(q, k, v, pos))
    for bad in (torch.tensor(pos), torch.tensor([pos], dtype=torch.int32),
                torch.tensor([pos, pos])):
        with pytest.raises(ValueError, match="one-element int64"):
            da_ops.decode_attention(q, k, v, bad)
    with pytest.raises(ValueError, match="outside the cache"):
        da_ops.decode_attention(q, k, v, torch.tensor([256]))


def test_decode_attention_ignores_stale_cache():
    """Entries beyond pos must not affect the output."""
    _, (q, k, v) = _inputs(5, [(1, 4, 32), (1, 128, 2, 32), (1, 128, 2, 32)],
                           "float32")
    out1 = da_ops.decode_attention(q, k, v, 63)
    k2, v2 = k.clone(), v.clone()
    k2[:, 64:] = 99.0
    v2[:, 64:] = -99.0
    out2 = da_ops.decode_attention(q, k2, v2, 63)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)


@pytest.mark.parametrize("pos", [-1, 128])
def test_decode_attention_rejects_pos_outside_cache(pos):
    _, (q, k) = _inputs(6, [(1, 4, 32), (1, 128, 2, 32)], "float32")
    with pytest.raises(ValueError, match="outside the cache"):
        da_ops.decode_attention(q, k, k, pos)


def test_cpu_wrappers_leave_launch_counters_at_zero():
    _, (x, q, k) = _inputs(7, [(4, 64), (1, 16, 4, 32), (1, 16, 2, 32)],
                           "float32")
    rms_ops.rmsnorm(x, torch.ones(64))
    rms_ops.add_rmsnorm(x, x, torch.ones(64))
    fa_ops.flash_attention(q, k, k)
    da_ops.decode_attention(q[:, 0], k, k, 9)
    assert rms_ops.rmsnorm.launches == rms_ops.add_rmsnorm.launches == 0
    assert fa_ops.flash_attention.launches == 0
    assert da_ops.decode_attention.launches == 0
