"""Hardware descriptors: the roofline of each registered accelerator,
and the distance between two of them.

A copy of the reference package's ``perfmodel/hardware.py``; the port
keeps its own because it imports nothing of the reference.  Every number
is the reference's: public datasheet peaks (dense bf16 tensor throughput,
HBM bandwidth, per-direction interconnect bandwidth, HBM capacity) and
the achievable fractions ``mfu_*``/``*_eff``, noted per profile below.

The registry's Alg 4 uses it two ways.  ``bench.harness.accelerator_name``
names the rows an H100 measures with a profile registered here
(``gpu-h100-sxm``).  Cross-hardware transfer (paper RQ4, Alg 8) scores
how far two descriptors sit in log-roofline space with
``hardware_distance``; the uncertainty layer adds it to the workload
distance ``d_min`` before the ``1 / (1 + d)`` confidence squash, so a fit
transferred to hardware it never measured reports lower confidence.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple, Union


@dataclasses.dataclass(frozen=True)
class HardwareProfile:
    name: str
    peak_flops: float          # bf16 FLOP/s per chip (dense)
    hbm_bw: float              # bytes/s per chip
    ici_bw: float              # bytes/s per link (intra-group collective)
    hbm_bytes: float           # capacity per chip
    # achievable fractions (matmul-efficiency asymptotes)
    mfu_prefill: float = 0.55
    mfu_decode: float = 0.70   # of the *bandwidth* roofline
    ici_eff: float = 0.80
    # dtype efficiency knobs: peak-FLOPs multiplier relative to bf16 when
    # serving in 1-byte (fp8/int8) or 4-byte (fp32) precision.  1.0 for
    # fp8 means "no fp8 tensor units — same rate as bf16" (TPU v5e, A100).
    fp8_flops_scale: float = 1.0
    fp32_flops_scale: float = 0.5
    # off-group interconnect (NIC / DCN), bytes/s per chip.  Not in the
    # single-group cost path; used as a descriptor feature for
    # cross-hardware distance and future multi-group scaling.
    net_bw: float = 25e9

    def flops_at(self, dtype_bytes: float) -> float:
        """Peak FLOP/s at the serving precision (pure in the descriptor).

        2-byte (bf16) is the calibration point; 1-byte engages the fp8
        knob, 4-byte the fp32 knob.  Fractional byte-widths interpolate
        in log2 space so the curve is monotone in precision."""
        if dtype_bytes == 2:
            return self.peak_flops
        if dtype_bytes <= 1:
            return self.peak_flops * self.fp8_flops_scale
        if dtype_bytes >= 4:
            return self.peak_flops * self.fp32_flops_scale
        if dtype_bytes < 2:     # (1, 2): blend bf16 <- fp8
            w = 2.0 - dtype_bytes
            return self.peak_flops * self.fp8_flops_scale ** w
        w = (dtype_bytes - 2.0) / 2.0   # (2, 4): blend bf16 -> fp32
        return self.peak_flops * self.fp32_flops_scale ** w

    def features(self) -> Dict[str, float]:
        """Descriptor features on the scale the cost functions see them:
        *delivered* rooflines (peak x achievable fraction), plus capacity
        and the compute:bandwidth intensity ratio."""
        flops = self.peak_flops * self.mfu_prefill
        bw = self.hbm_bw * self.mfu_decode
        return {
            "flops": flops,
            "hbm_bw": bw,
            "ici_bw": self.ici_bw * self.ici_eff,
            "hbm_bytes": self.hbm_bytes,
            "intensity": flops / bw,    # FLOP per byte at the ridge
        }


# -- registered descriptors --------------------------------------------------
# TPU v5e: 197 TFLOP/s bf16, 819 GB/s HBM2, 16 GiB/chip, ICI ~50 GB/s per
# link (numbers match EXPERIMENTS.md).  No fp8 tensor path.
TPU_V5E = HardwareProfile(
    name="tpu-v5e", peak_flops=197e12, hbm_bw=819e9, ici_bw=50e9,
    hbm_bytes=16e9)

# TPU v4: 275 TFLOP/s bf16, 1228 GB/s HBM2, 32 GiB/chip, 3D-torus ICI
# ~50 GB/s per link.  No fp8 tensor path.
TPU_V4 = HardwareProfile(
    name="tpu-v4", peak_flops=275e12, hbm_bw=1228e9, ici_bw=50e9,
    hbm_bytes=32e9)

# NVIDIA A100-SXM 80G: 312 TFLOP/s dense bf16, 2039 GB/s HBM2e, 80 GiB,
# NVLink3 300 GB/s per direction per GPU.  No fp8 units (fp8 runs at the
# bf16 rate); fp32 tensor (TF32) ~0.5x.
A100_80G = HardwareProfile(
    name="gpu-a100-80g", peak_flops=312e12, hbm_bw=2039e9, ici_bw=300e9,
    hbm_bytes=80e9, mfu_prefill=0.45, mfu_decode=0.60, ici_eff=0.70,
    net_bw=50e9)

# NVIDIA H100-SXM: 989 TFLOP/s dense bf16, 3350 GB/s HBM3, 80 GiB,
# NVLink4 450 GB/s per direction per GPU; fp8 tensor core 2x bf16.
H100_SXM = HardwareProfile(
    name="gpu-h100-sxm", peak_flops=989e12, hbm_bw=3350e9, ici_bw=450e9,
    hbm_bytes=80e9, mfu_prefill=0.45, mfu_decode=0.60, ici_eff=0.70,
    fp8_flops_scale=2.0, net_bw=50e9)

# AMD MI300X: 1307 TFLOP/s dense bf16, 5300 GB/s HBM3, 192 GiB,
# Infinity Fabric ~128 GB/s per link (7 links/GPU); fp8 2x bf16.
MI300X = HardwareProfile(
    name="gpu-mi300x", peak_flops=1307e12, hbm_bw=5300e9, ici_bw=128e9,
    hbm_bytes=192e9, mfu_prefill=0.40, mfu_decode=0.55, ici_eff=0.65,
    fp8_flops_scale=2.0, net_bw=50e9)

# NVIDIA L4 (inference card): 121 TFLOP/s dense bf16, 300 GB/s GDDR6,
# 24 GiB, PCIe gen4 x16 ~32 GB/s (no NVLink); fp8 2x bf16.
L4 = HardwareProfile(
    name="gpu-l4", peak_flops=121e12, hbm_bw=300e9, ici_bw=32e9,
    hbm_bytes=24e9, mfu_prefill=0.35, mfu_decode=0.50, ici_eff=0.50,
    fp8_flops_scale=2.0, net_bw=12e9)

# stand-in for an accelerator with a very different compute:bandwidth
# ratio — the paper's RQ4 hardware-mismatch case (Qwen2-7B on Intel PVC
# vs the H100-trained predictor)
LEGACY_GPU = HardwareProfile(
    name="legacy-gpu", peak_flops=105e12, hbm_bw=1600e9, ici_bw=25e9,
    hbm_bytes=48e9, mfu_prefill=0.42, mfu_decode=0.55, ici_eff=0.6)

PROFILES = {p.name: p for p in (
    TPU_V5E, TPU_V4, A100_80G, H100_SXM, MI300X, L4, LEGACY_GPU)}


def profile(name: str) -> HardwareProfile:
    """Look up a registered descriptor by name."""
    try:
        return PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown hardware profile {name!r}; registered: "
                       f"{sorted(PROFILES)}") from None


ProfileLike = Union[str, HardwareProfile]


def _resolve(p: ProfileLike) -> HardwareProfile:
    return profile(p) if isinstance(p, str) else p


# feature weights for the distance: capacity shifts the saturation point
# (via the KV budget) but not the step-time curve shape, so it counts
# half; the delivered rooflines and the intensity ratio count full.
_DIST_WEIGHTS = {"flops": 1.0, "hbm_bw": 1.0, "ici_bw": 1.0,
                 "hbm_bytes": 0.5, "intensity": 1.0}


def hardware_distance(a: ProfileLike, b: ProfileLike) -> float:
    """Descriptor distance in log-roofline space.

    Weighted mean of ``|log2(feature_a / feature_b)|`` over the
    ``features()`` axes: 0 for identical descriptors, ~1 when the
    delivered rooflines differ by about 2x across the board.  The scale
    is chosen to compose with the Alg 8 workload distance — the
    uncertainty layer forms ``d_eff = d_min + weight * d_hw`` before the
    ``1 / (1 + d)`` squash, so any nonzero hardware distance *strictly*
    lowers transferred confidence on the same workloads."""
    fa, fb = _resolve(a).features(), _resolve(b).features()
    num = sum(w * abs(math.log2(fa[k] / fb[k]))
              for k, w in _DIST_WEIGHTS.items())
    return num / sum(_DIST_WEIGHTS.values())


def feature_row(p: ProfileLike) -> Dict[str, float]:
    """Hardware feature columns for ALA database rows (log10 scale, so
    they sit in the same numeric range as the workload features)."""
    f = _resolve(p).features()
    return {f"hw_{k}": math.log10(v) for k, v in f.items()}


def feature_names() -> Tuple[str, ...]:
    return tuple(f"hw_{k}" for k in TPU_V5E.features())
