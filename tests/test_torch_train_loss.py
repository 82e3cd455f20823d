"""``Model.train_loss`` and every parameter's gradient against
``jax.value_and_grad`` of the reference's ``Model.train_loss``, from the
same parameters (``weights.params_from_jax``) and batch: fp32 loss within
1e-5 relative, each gradient within 1e-4 of its max-abs; the bf16 loss
within 2e-2; ``remat=True`` gives the same gradients; the cross entropy
with masked labels.  The dense and MoE (its aux term) smoke models here;
the encoder-decoder and vision ones in ``test_torch_train_loss_encdec.py``,
the recurrent ones in ``test_torch_train_loss_ssm.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jlayers

from repro_torch.models import layers as tlayers

from _torch_train_cases import check, pair, port_model


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.2-3b",
                                  "phi3.5-moe-42b-a6.6b"])
def test_train_loss_and_grads_match_jax_fp32(arch):
    check(arch)


def test_train_loss_matches_jax_bf16():
    jloss, _, model, tb = pair("qwen3-0.6b", "bfloat16")
    loss = model.train_loss(tb)
    assert loss.dtype == torch.float32
    loss.backward()
    loss = float(loss.detach())
    assert abs(loss - jloss) <= 2e-2 * abs(jloss), (loss, jloss)
    assert all(p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()
               for p in model.parameters())


def test_remat_gives_the_same_gradients():
    """Recomputing each period in the backward changes no gradient (the
    MoE smoke model: its aux loss crosses the recomputed periods too)."""
    model, tb = port_model("phi3.5-moe-42b-a6.6b")
    remat, _ = port_model("phi3.5-moe-42b-a6.6b", remat=True)
    for m in (model, remat):
        m.train_loss(tb).backward()
    for (name, p), q in zip(model.named_parameters(), remat.parameters()):
        np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


def test_cross_entropy_with_masked_labels_matches_jax():
    rng = np.random.default_rng(3)
    vocab, padded = 50, 64
    logits = rng.standard_normal((3, 7, padded)).astype(np.float32)
    labels = rng.integers(0, vocab, (3, 7)).astype(np.int32)
    labels[0, :4] = [vocab, padded - 1, -1, vocab + 5]   # masked
    jl, jg = jax.value_and_grad(jlayers.cross_entropy)(
        jnp.asarray(logits), jnp.asarray(labels), vocab)
    t = torch.from_numpy(logits).requires_grad_()
    loss = tlayers.cross_entropy(t, torch.from_numpy(labels).long(), vocab)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-6)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    assert not t.grad[0, :4].abs().sum()


def test_cross_entropy_chunks_and_bf16_logits(monkeypatch):
    """Rows taken a few at a time give the one-pass result; bf16 logits
    keep a bf16 gradient."""
    rng = np.random.default_rng(4)
    logits = torch.from_numpy(rng.standard_normal((9, 32)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 30, 9))
    whole = tlayers.cross_entropy(logits, labels, 30)
    monkeypatch.setattr(tlayers, "CE_CHUNK_ELEMENTS", 64)   # 2 rows a chunk
    t = logits.clone().requires_grad_()
    chunked = tlayers.cross_entropy(t, labels, 30)
    chunked.backward()
    np.testing.assert_allclose(float(chunked), float(whole), rtol=1e-6)
    want = torch.softmax(logits, -1)
    want[torch.arange(9), labels] -= 1
    np.testing.assert_allclose(t.grad.numpy(), (want / 9).numpy(),
                               rtol=1e-5, atol=1e-7)
    b = logits.to(torch.bfloat16).requires_grad_()
    tlayers.cross_entropy(b, labels, 30).backward()
    assert b.grad.dtype == torch.bfloat16
