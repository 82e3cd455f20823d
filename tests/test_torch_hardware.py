"""The port's hardware descriptors against the reference's
``perfmodel/hardware.py``: the same registered profiles field for field,
``flops_at`` at every precision, ``hardware_distance`` for every pair and
``feature_row``, all bit for bit (the port keeps a copy of the module)."""
import dataclasses

import pytest

from repro.perfmodel import hardware as ref

from repro_torch.bench.harness import H100
from repro_torch.perfmodel import hardware


def test_profiles_equal_the_reference_field_for_field():
    assert list(hardware.PROFILES) == list(ref.PROFILES)
    for name, p in hardware.PROFILES.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(ref.PROFILES[name])
        assert p.features() == ref.PROFILES[name].features()
    assert H100 in hardware.PROFILES


@pytest.mark.parametrize("dtype_bytes", [0.5, 1, 1.5, 2, 3, 4, 8])
def test_flops_at_equals_the_reference(dtype_bytes):
    for name, p in hardware.PROFILES.items():
        assert p.flops_at(dtype_bytes) == \
            ref.PROFILES[name].flops_at(dtype_bytes)


def test_distance_and_feature_rows_equal_the_reference():
    names = sorted(hardware.PROFILES)
    for a in names:
        assert hardware.feature_row(a) == ref.feature_row(a)
        assert hardware.feature_row(hardware.PROFILES[a]) == \
            ref.feature_row(a)
        for b in names:
            assert hardware.hardware_distance(a, b) == \
                ref.hardware_distance(a, b)
    assert hardware.feature_names() == ref.feature_names()
    with pytest.raises(KeyError, match="unknown hardware"):
        hardware.profile("martian-npu")
