"""The kernels' abstract forms on the CPU: each ``repro_torch`` op (K1
plain, fused and backward; K2 with and without the log-sum-exp, and its
backward; K3) on meta tensors and under ``FakeTensorMode`` gives the
plain version's output shapes and dtypes in the layout the CUDA launch
allocates, launches nothing and builds nothing; each FLOP formula, read
through ``FlopCounterMode``, equals the kernel's own count function, and
where the plain version runs the same products (K2 full, its backward's
five products, K3 over the whole cache) ``FlopCounterMode`` over the
plain version.  The CUDA implementations are held to the plain versions
on the card (``chip_smoke.py``)."""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.rmsnorm import ops as rms_ops

COUNTERS = (rms_ops.rmsnorm, rms_ops.add_rmsnorm, rms_ops.rmsnorm_bwd,
            fa_ops.flash_attention, fa_ops.flash_attention_bwd,
            da_ops.decode_attention)
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(autouse=True)
def _no_launch(monkeypatch):
    """Every launch counter unchanged, and nothing built."""
    before = [c.launches for c in COUNTERS]

    def refuse(*_):
        raise AssertionError("a shape-only op reached the build")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    yield
    assert [c.launches for c in COUNTERS] == before


def _meta(t):
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device="meta")


def _same_layout(got, want):
    """``got`` (an op's shape-only result) has the plain version's shape
    and dtype, laid out as the CUDA launch allocates it: contiguous."""
    assert got.device.type == "meta"
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.stride() == want.contiguous().stride()


def _flops(fn, *args):
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return counter.get_total_flops()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(8, 64), (3, 5, 128), (2, 33)])
def test_rmsnorm_ops_shape_only(shape, dtype):
    g = torch.Generator().manual_seed(0)
    x, r, dy, ds = (torch.randn(shape, generator=g).to(dtype)
                    for _ in range(4))
    scale = torch.randn(shape[-1], generator=g)
    rows, d = x.numel() // shape[-1], shape[-1]
    m = [_meta(t) for t in (x, r, scale, dy, ds)]
    _same_layout(rms_ops.rmsnorm(m[0], m[2]), rms_ops.rmsnorm(x, scale))
    for got, want in zip(rms_ops.add_rmsnorm(m[0], m[1], m[2]),
                         rms_ops.add_rmsnorm(x, r, scale)):
        _same_layout(got, want)
    for extra in ((), (m[4],)):
        plain = rms_ops.rmsnorm_bwd(x, scale, dy, *((ds,) if extra else ()))
        for got, want in zip(rms_ops.rmsnorm_bwd(m[0], m[2], m[3], *extra),
                             plain):
            _same_layout(got, want)
    # K1 is elementwise, which FlopCounterMode leaves at 0 in the plain
    # version; its formula counts the kernel's own float32 operations
    assert _flops(rms_ops.rmsnorm, x, scale) == 0
    assert _flops(rms_ops.rmsnorm, m[0], m[2]) == \
        rms_ops.rmsnorm_flops(rows, d) == 4 * rows * d
    assert _flops(rms_ops.add_rmsnorm, m[0], m[1], m[2]) == \
        rms_ops.rmsnorm_flops(rows, d, fused=True) == 5 * rows * d
    assert _flops(rms_ops.rmsnorm_bwd, m[0], m[2], m[3], m[4]) == \
        rms_ops.rmsnorm_bwd_flops(rows, d) == 10 * rows * d


def test_rmsnorm_op_checks_shapes():
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(torch.empty(4, 8, device="meta"),
                        torch.empty(7, device="meta"))
    with pytest.raises(ValueError):
        rms_ops.add_rmsnorm(torch.empty(4, 8, device="meta"),
                            torch.empty(4, 7, device="meta"),
                            torch.empty(8, device="meta"))


def _qkv(b, s, sk, h, kv, dh, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, dh, generator=g).to(dtype),
            torch.randn(b, sk, kv, dh, generator=g).to(dtype),
            torch.randn(b, sk, kv, dh, generator=g).to(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,sk,h,kv,dh", [(2, 64, 64, 4, 2, 32),
                                            (1, 50, 77, 8, 2, 16),
                                            (2, 96, 40, 6, 3, 64)])
def test_flash_attention_ops_shape_only(b, s, sk, h, kv, dh, causal, dtype):
    q, k, v = _qkv(b, s, sk, h, kv, dh, dtype)
    mq, mk, mv = map(_meta, (q, k, v))
    _same_layout(fa_ops.flash_attention(mq, mk, mv, causal=causal),
                 fa_ops.flash_attention(q, k, v, causal=causal))
    out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
    for got, want in zip(fa_ops.flash_attention_lse(mq, mk, mv,
                                                    causal=causal),
                         (out, lse)):
        _same_layout(got, want)
    dout = torch.randn_like(out)
    plain = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                       causal=causal)
    got = fa_ops.flash_attention_bwd(mq, mk, mv, _meta(out), _meta(lse),
                                     _meta(dout), causal=causal)
    for g_, w in zip(got, plain):
        _same_layout(g_, w)
    fwd = fa_ops.flash_attention_flops(b, s, sk, h, dh, causal)
    bwd = fa_ops.flash_attention_bwd_flops(b, s, sk, h, dh, causal)
    assert _flops(fa_ops.flash_attention, mq, mk, mv, causal) == fwd
    assert _flops(fa_ops.flash_attention_lse, mq, mk, mv, causal) == fwd
    assert _flops(fa_ops.flash_attention_bwd, mq, mk, mv, _meta(out),
                  _meta(lse), _meta(dout), causal) == bwd
    pairs = sum(min(i + 1, sk) for i in range(s)) if causal else s * sk
    assert fa_ops.causal_pairs(s, sk) == sum(min(i + 1, sk)
                                             for i in range(s))
    assert fwd == 4 * b * h * dh * pairs
    assert bwd == 2 * fa_ops.BWD_PRODUCTS * b * h * dh * pairs
    if not causal:
        # the plain versions run the same products over every pair: the
        # forward's two, the backward's five (QK^T again, dO V^T, P^T dO,
        # dS K, dS^T Q)
        assert _flops(fa_ops.flash_attention, q, k, v, False) == fwd
        assert _flops(fa_ops.flash_attention_bwd, q, k, v, out, lse, dout,
                      False) == fa_ops.flash_attention_bwd_flops(
                          b, s, sk, h, dh, False,
                          products=fa_ops.BWD_PRODUCTS_NEEDED)


def test_flash_attention_bwd_op_wants_the_lse():
    q, k, v = (_meta(t) for t in _qkv(1, 8, 8, 2, 1, 16, torch.float32))
    with pytest.raises(ValueError):
        fa_ops.flash_attention_bwd(q, k, v, q, None, q)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,h,kv,t,dh", [(2, 8, 2, 128, 64),
                                         (3, 4, 2, 77, 16),
                                         (1, 32, 8, 576, 128)])
def test_decode_attention_op_shape_only(b, h, kv, t, dh, dtype):
    g = torch.Generator().manual_seed(1)
    q = torch.randn(b, h, dh, generator=g).to(dtype)
    k = torch.randn(b, t, kv, dh, generator=g).to(dtype)
    v = torch.randn(b, t, kv, dh, generator=g).to(dtype)
    want = da_ops.decode_attention(q, k, v, t - 1)
    mq, mk, mv = map(_meta, (q, k, v))
    pos_t = torch.full((1,), t - 1, dtype=torch.int64, device="meta")
    for pos in (t - 1, pos_t):
        _same_layout(da_ops.decode_attention(mq, mk, mv, pos), want)
        assert _flops(da_ops.decode_attention, mq, mk, mv, pos) == \
            da_ops.decode_attention_flops(b, h, dh, t) == 4 * b * h * dh * t
    # the plain version reads every slot, and the kernel pos + 1 of them:
    # equal at the cache's last position
    assert _flops(da_ops.decode_attention, q, k, v, t - 1) == \
        da_ops.decode_attention_flops(b, h, dh, t)


def test_ops_under_fake_tensor_mode():
    """``FakeTensorMode`` over fake CUDA tensors takes the same shape-only
    forms (forward: a CPU build of torch has no CUDA autograd)."""
    with FakeTensorMode():
        x = torch.empty(4, 64, device="cuda", dtype=torch.bfloat16)
        y = rms_ops.rmsnorm(x, torch.empty(64, device="cuda"))
        q = torch.empty(2, 32, 4, 64, device="cuda", dtype=torch.bfloat16)
        kv = torch.empty(2, 32, 2, 64, device="cuda", dtype=torch.bfloat16)
        o = fa_ops.flash_attention(q, kv, kv)
        d = da_ops.decode_attention(
            torch.empty(2, 4, 64, device="cuda", dtype=torch.bfloat16),
            kv, kv, torch.full((1,), 31, device="cuda"))
    assert (y.shape, y.device.type) == ((4, 64), "cuda")
    assert o.shape == q.shape and o.is_contiguous()
    assert d.shape == (2, 4, 64) and d.device.type == "cuda"


def test_ops_are_defined_in_one_namespace():
    names = {"rmsnorm", "add_rmsnorm", "rmsnorm_bwd", "flash_attention",
             "flash_attention_lse", "flash_attention_bwd",
             "decode_attention"}
    for name in names:
        op = getattr(torch.ops.repro_torch, name)
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            op.default.name(), "CUDA")
        assert torch._C._dispatch_has_kernel_for_dispatch_key(
            op.default.name(), "Meta")
