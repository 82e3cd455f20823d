"""The harness on a CUDA card at smoke size: the graphed engine, the
traced request and every reader, for both smoke cells.  Skips without a
card; on one:

    PYTHONPATH=src python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py
"""
import time

import pytest

from _perfbench_cells import smoke_root
from perfbench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["dense.smoke", "moe.smoke"])
def test_every_metric_is_read_on_the_card(card, tmp_path, cell):
    root = smoke_root(tmp_path)
    e2e = harness.run_cell(root, cell, 5, 0.5, False, "cuda", time.time())
    traced = harness.run_cell(root, cell, 6, 0.5, True, "cuda", time.time())
    assert e2e["correct"] and traced["correct"]
    assert set(e2e["metrics"]) == {"out_tok_s", "ttft_ms", "peak_mem_gb",
                                   "setup_s"}
    # the H100 is in the table of peaks, so every per-layer metric reads
    spec = harness.load_cell(root, cell)
    assert set(traced["metrics"]) == {m["name"] for m in spec.per_layer}
    dev = traced["device"]
    assert 0 < dev["busy_s"] <= dev["window_s"]
