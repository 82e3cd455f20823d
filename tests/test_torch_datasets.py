"""The port's dataset generators (``bench/datasets.py``) against the cache
in ``results/data/`` and against the JAX package's generators: the three
datasets at their defaults equal the cached ``.npz`` bit for bit in every
cached column (the cache predates the ``hw_*`` descriptor columns, which
equal the reference's generator's), and other seeds, repetitions, models
and frameworks give the reference's rows bit for bit.  ``load_or_make``
writes only under a ``DATA_DIR`` it is pointed to (``tmp_path`` here)."""
import pytest
import torch

from repro.bench import datasets as jax_datasets
from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config

from repro_torch.bench import datasets
from repro_torch.configs import ARCHS, get_config
from repro_torch.core.dataset import Dataset

GENERATORS = {"inhouse": "make_inhouse_dataset",
              "suite": "make_suite_dataset",
              "mismatch": "make_mismatch_dataset"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _same_columns(got, want, cols):
    for k in cols:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("name", list(GENERATORS))
def test_defaults_reproduce_the_cache_bit_for_bit(name):
    got = getattr(datasets, GENERATORS[name])()
    cache = Dataset.load(datasets.DATA_DIR / name)
    assert len(got) == len(cache) == {"inhouse": 4800, "suite": 11088,
                                      "mismatch": 336}[name]
    _same_columns(got, cache, cache.cols)
    want = getattr(jax_datasets, GENERATORS[name])()
    assert list(got.cols) == list(want.cols)
    _same_columns(got, want, want.cols)
    assert sorted(set(got.cols) - set(cache.cols)) == [
        "hw_flops", "hw_hbm_bw", "hw_hbm_bytes", "hw_ici_bw", "hw_intensity"]


@pytest.mark.parametrize("name,kw", [
    ("inhouse", dict(seed=3, reps=2)),
    ("suite", dict(seed=5, reps=1, models=["qwen3-0.6b", "xlstm-125m",
                                            "jamba-1.5-large-398b"],
                   frameworks=["tgi-jax", "trt-jax"])),
    ("suite", dict(seed=9, reps=2, models=["whisper-medium"])),
    ("mismatch", dict(seed=7, reps=2, model="llama3.2-3b")),
], ids=["inhouse", "suite-3-models", "suite-whisper", "mismatch"])
def test_other_arguments_give_the_references_rows(name, kw):
    got = getattr(datasets, GENERATORS[name])(**kw)
    want = getattr(jax_datasets, GENERATORS[name])(**kw)
    assert list(got.cols) == list(want.cols) and len(got) == len(want)
    _same_columns(got, want, want.cols)


def test_grids_frameworks_and_model_order_are_the_references():
    for k in ("INHOUSE_II", "INHOUSE_OO", "INHOUSE_BB", "SUITE_II",
              "SUITE_OO", "SUITE_BB", "FRAMEWORKS"):
        assert getattr(datasets, k) == getattr(jax_datasets, k), k
    # the suite draws its models in the reference's ARCHS order
    assert datasets.SUITE_MODELS == JAX_ARCHS
    assert set(datasets.SUITE_MODELS) == set(ARCHS)
    for arch in ARCHS:
        assert datasets._tp_degree(get_config(arch)) == \
            jax_datasets._tp_degree(jax_get_config(arch))


def test_load_or_make_reads_the_cache_else_makes_and_saves(tmp_path,
                                                           monkeypatch):
    cached = datasets.load_or_make("mismatch")
    assert "hw_flops" not in cached.cols        # the committed cache
    monkeypatch.setattr(datasets, "DATA_DIR", tmp_path)
    made = datasets.load_or_make("mismatch", seed=4, reps=1)
    assert (tmp_path / "mismatch.npz").exists()
    want = jax_datasets.make_mismatch_dataset(seed=4, reps=1)
    _same_columns(made, want, want.cols)
    # the second call reads what the first saved, whatever it is asked
    again = datasets.load_or_make("mismatch", seed=99)
    _same_columns(again, made, made.cols)
    with pytest.raises(KeyError):
        datasets.load_or_make("nope")


def test_train_test_split_is_the_references():
    ds = datasets.make_mismatch_dataset()
    jds = jax_datasets.make_mismatch_dataset()
    for seed in (0, 3):
        for got, want in zip(datasets.train_test_split(ds, 0.3, seed),
                             jax_datasets.train_test_split(jds, 0.3, seed)):
            _same_columns(got, want, want.cols)
