"""The controls at a size a test run holds: the plain reference computed in
fp8 (e4m3) and put in the program's place, at the inputs of every product
(``fp8_products``) and besides wherever the program holds bf16 (``fp8``),
is judged not correct by the harness's own predicate at the smoke cells'
limits, on every seed tried, where the bf16 program is judged correct.  At
the cells' own sizes on the card ``perfbench/control.py`` reads both; the
limits in ``perfbench/limits/`` lie between those readings (PERF.md)."""
import time

import pytest

from _perfbench_cells import smoke_root
from perfbench import check, harness


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("cell", ["dense.smoke", "moe.smoke"])
def test_the_control_reads_wider_than_the_program(tmp_path, cell, seed):
    out = harness.run_cell(smoke_root(tmp_path), cell, seed, 0.05, False,
                           "cpu", time.time(), controls=True)
    assert out["correct"]
    assert out["controls_correct"] == {name: False
                                       for name in check.CONTROLS}
    c = out["compared"]
    for name in check.CONTROLS:
        assert (c[f"{name}.logit_rel_err"]["value"]
                > c["logit_rel_err"]["value"])
