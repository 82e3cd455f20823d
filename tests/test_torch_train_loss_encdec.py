"""``Model.train_loss`` and its gradients against the reference's for the
encoder-decoder and vision smoke models (whisper-medium: the encoder,
cross attention over its frames; internvl2-1b: the projected patches
before the text, whose positions the loss skips), fp32, at the
tolerances of ``test_torch_train_loss.py``."""
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


@pytest.mark.parametrize("arch", ["whisper-medium", "internvl2-1b"])
def test_train_loss_and_grads_match_jax_fp32(arch):
    check(arch)
