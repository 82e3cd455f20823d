"""``Model.train_loss`` and its gradients against the reference's for
jamba's smoke model (its period of Mamba, attention and MoE blocks, the
aux loss included), fp32, at the tolerances of
``test_torch_train_loss.py``."""
import pytest
import torch

from _torch_train_cases import check


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_train_loss_and_grads_match_jax_fp32():
    check("jamba-1.5-large-398b")
