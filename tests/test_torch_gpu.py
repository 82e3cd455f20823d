"""The torch port's CUDA and Triton kernels against their plain versions,
on a CUDA card: the shape sweeps of ``test_kernels.py``, ragged lengths,
llama3.1-8b widths and a cache holding NaN past the fill level; then the
smoke model on the card against the same weights on the CPU.  Tolerances:
fp32 2e-5, bf16 2e-2, as ``test_kernels.py``.  Every test needs a card and
skips without one; this file imports no JAX, so it runs where only torch
is installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py
"""
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention.ref import decode_attention_ref
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
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
