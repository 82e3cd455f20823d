"""The port's synthetic data pipeline against the reference's: batches
bit for bit for text, vision (patches) and audio (frames) configs at
steps 0, 7 and 123, and ports of the reference's pipeline tests
(``tests/test_fault_tolerance.py``)."""
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs.shapes import ShapeSpec as JShapeSpec
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.data.pipeline import SyntheticPipeline as JSyntheticPipeline

from repro_torch.configs import get_smoke_config
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.data.pipeline import PipelineConfig, SyntheticPipeline


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-1b",
                                  "whisper-medium"])
@pytest.mark.parametrize("seed", [0, 5])
def test_batches_are_the_references_bit_for_bit(arch, seed):
    jp = JSyntheticPipeline(jax_get_smoke_config(arch),
                            JShapeSpec("t", 32, 2, "train"),
                            JPipelineConfig(seed=seed))
    tp = SyntheticPipeline(get_smoke_config(arch),
                           ShapeSpec("t", 32, 2, "train"),
                           PipelineConfig(seed=seed))
    for step in (0, 7, 123):
        jb, tb = jp.batch_at(step), tp.batch_at(step)
        assert list(jb) == list(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape
            assert jb[k].tobytes() == tb[k].tobytes(), (arch, step, k)


def test_pipeline_deterministic_and_resumable():
    cfg = get_smoke_config("llama3.2-3b")
    shape = ShapeSpec("t", seq_len=32, global_batch=2, kind="train")
    p1 = SyntheticPipeline(cfg, shape, PipelineConfig(seed=5))
    p2 = SyntheticPipeline(cfg, shape, PipelineConfig(seed=5))
    for step in (0, 7, 123):
        b1, b2 = p1.batch_at(step), p2.batch_at(step)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["labels"], b2["labels"])
    # different steps differ
    assert not np.array_equal(p1.batch_at(0)["tokens"],
                              p1.batch_at(1)["tokens"])


def test_pipeline_labels_are_shifted_tokens():
    cfg = get_smoke_config("llama3.2-3b")
    shape = ShapeSpec("t", seq_len=16, global_batch=2, kind="train")
    b = SyntheticPipeline(cfg, shape).batch_at(0)
    assert b["tokens"].shape == (2, 16)
    assert (b["labels"] < cfg.vocab_size).all()
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_pipeline_vision_and_audio_fronts():
    vcfg = get_smoke_config("internvl2-1b")
    shape = ShapeSpec("t", seq_len=32, global_batch=2, kind="train")
    vb = SyntheticPipeline(vcfg, shape).batch_at(0)
    assert vb["patches"].shape == (2, vcfg.n_patches, vcfg.d_model)
    assert vb["tokens"].shape[1] == 32 - vcfg.n_patches

    acfg = get_smoke_config("whisper-medium")
    ab = SyntheticPipeline(acfg, shape).batch_at(0)
    assert ab["frames"].shape == (2, acfg.encoder_seq, acfg.d_model)
