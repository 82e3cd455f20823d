"""The Fig 7 baselines of the port (``make_baselines(device="cpu")``)
against the JAX package's on ``inhouse`` 70/30 (seed 0): the two GBTs and
the random forest predict bit for bit (float64 histograms on both sides,
the same trees); linear regression within 1e-9 relative (``lstsq``)."""
import numpy as np
import pytest
import torch

from repro.core.baselines import make_baselines as jax_make_baselines

from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
from repro_torch.core.baselines import make_baselines


@pytest.fixture(scope="module")
def split():
    train, test = train_test_split(make_inhouse_dataset(), 0.3)
    return train.workload, test.workload


@pytest.mark.parametrize("name", ["linear_regression", "vanilla_xgboost",
                                  "random_forest", "gradient_boosting"])
def test_baseline_predicts_as_the_reference(split, name):
    train, test = split
    got = make_baselines("cpu")[name].fit(*train).predict(*test[:3])
    want = jax_make_baselines()[name].fit(*train).predict(*test[:3])
    assert got.shape == want.shape == (len(test[0]),)
    if name == "linear_regression":
        np.testing.assert_allclose(got, want, rtol=1e-9)
    else:
        np.testing.assert_array_equal(got, want)


def test_baselines_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_baselines()
