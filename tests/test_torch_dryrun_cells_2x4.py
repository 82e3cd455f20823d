"""``launch/dryrun.py::run_cell`` traces every arch's smoke config at the
four shapes on a (2, 4) mesh over 8 ranks, MoE, the recurrent blocks and whisper's encoder
included (``tests/_torch_dryrun_cases.py`` says what is checked)."""
import pytest

from _torch_dryrun_cases import check_smoke_cells
from repro_torch.configs import ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_run_cell_traces_every_smoke_config(monkeypatch, arch):
    check_smoke_cells(monkeypatch, arch, "2x4")
