"""The Trainer's policy path (``Trainer(policy=...)``, the reference's
``launch/steps.py::build_train_step``) on eight gloo ranks, a (data 2,
model 4) mesh, against the policy-free Trainer from the same parameters
and batches: qwen3-0.6b's smoke config in fp32, 3 AdamW steps, each
step's loss within 1e-4 relative and every parameter within 1e-4 of its
norm, as ``test_torch_trainer.py`` holds the Trainer to the reference's;
parameters DTensors placed by ``tree_shardings``, the moments by its
ZeRO-1 variant; and a policy Trainer restarted from the step-2
checkpoint, distributed by ``restore_checkpoint(shardings=)``, ending at
the same parameters.  The ranks run in one subprocess with its own
timeout (``tests/_torch_dist_cases.py``)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models.transformer import Model

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("train_policy")
    cfg = get_smoke_config("qwen3-0.6b").scaled(compute_dtype=torch.float32)
    model = Model(cfg).init(torch.Generator().manual_seed(3), train=True)
    torch.save({k: v.detach().clone() for k, v in model.named_parameters()},
               d / "train_params.pt")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    out = subprocess.run([sys.executable,
                          str(REPO / "tests" / "_torch_dist_cases.py"),
                          "train_policy", str(d)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return np.load(d / "train_policy.npz")


def test_policy_steps_match_the_policy_free_trainer(run):
    np.testing.assert_allclose(run["loss_sharded"], run["loss_plain"],
                               rtol=1e-4)
    np.testing.assert_allclose(run["gnorm_sharded"], run["gnorm_plain"],
                               rtol=1e-4)
    for i in range(len(run["names"])):
        a, b = run[f"plain_{i}"], run[f"sharded_{i}"]
        assert np.linalg.norm(b - a) <= 1e-4 * np.linalg.norm(a), \
            run["names"][i]


def test_policy_state_is_placed_by_tree_shardings(run):
    """Every parameter a DTensor; the wq/wk/wv heads on ``model`` (dim 1
    of (D, H, Dh)), and ZeRO-1 adds ``data`` to each moment (the stack
    dim's axis moved onto the per-period tensor)."""
    assert bool(run["all_dtensor"])
    names = list(run["names"])
    p_dims, m_dims = run["p_shard_dims"], run["m_shard_dims"]
    wq = names.index("blocks.0.0.attn.wq")
    assert p_dims[wq].tolist() == [-1, 1]
    assert all(row[0] != -1 for row in m_dims)
    assert all(row[1] == prow[1] for row, prow in zip(m_dims, p_dims))


def test_policy_restart_resumes_to_the_same_parameters(run):
    assert run["resumed_steps"].tolist() == [2]
    for i in range(len(run["names"])):
        np.testing.assert_array_equal(run[f"resumed_{i}"],
                                      run[f"sharded_{i}"])
