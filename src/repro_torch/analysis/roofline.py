"""Three-term roofline analysis from the dry run's traced records
(``launch/dryrun.py``), the reference package's ``analysis/roofline.py``.

Method (``results/torch/EXPERIMENTS.md`` §Roofline):

* Per-cell costs are extrapolated from depth-1 and depth-2 variants of
  the full-width config (``--unroll-periods``), as the reference does:

      body  = cost(u2) - cost(u1)        # one period (+1 enc layer)
      base  = cost(u1) - body            # embeddings, head, loss, optimizer
      total = base + n_periods * body

  The same extrapolation applies to per-collective-kind bytes.
* No inner-scan correction is added.  XLA counts a while-loop body once,
  so the reference adds ``(trip_count - 1) x body`` for the Mamba, sLSTM,
  mLSTM and chunked-attention scans (``inner_scan_correction``, kept here
  for comparison); the port's eager trace counts every trip of every
  loop, and adding it would count them twice.  Records carry
  ``scan_correction`` as zeros.
* Terms (seconds, per device: the trace counts one rank's local ops):
      compute    = FLOPs / peak_FLOPs
      memory     = bytes_accessed / HBM_bw
      collective = collective_bytes / link_bw

Hardware constants: one NVIDIA H100 SXM (80 GB HBM3, 700 W limit), from
its datasheet: 989e12 dense bf16 FLOP/s, 3.35e12 HBM bytes/s; 50e9 link
bytes/s, one 400 Gb/s NDR NIC a GPU, the slowest link that a 16-wide
axis of 8-GPU nodes crosses.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, Optional

from repro_torch.configs import get_config
from repro_torch.configs.shapes import ShapeSpec, get_shape
from repro_torch.models import ssm
from repro_torch.models.config import (MIXER_MAMBA, MIXER_MLSTM, MIXER_SLSTM,
                                       ModelConfig)

PEAK_FLOPS = 989e12      # H100 SXM, dense bf16, 700 W
HBM_BW = 3.35e12         # H100 SXM HBM3
LINK_BW = 50e9           # 400 Gb/s NDR InfiniBand, one NIC a GPU

# the reference's chunked-attention scan (its models/attention.py), which
# the port does not run (K2 is one kernel), for inner_scan_correction
CHUNKED_ATTN_MIN_SEQ = 8_192
CHUNK_KV = 2_048

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch"
DRYRUN = RESULTS / "dryrun"

METHOD_NOTE = ("no scan correction: the eager trace counts every trip of "
               "the Mamba, sLSTM and mLSTM loops")


# ---------------------------------------------------------------------------
# the reference's analytic corrections for inner recurrent scans (per
# device); the port's roofline does not add them (see the module docstring)
# ---------------------------------------------------------------------------

def inner_scan_correction(cfg: ModelConfig, shape: ShapeSpec,
                          chips: int) -> Dict[str, float]:
    """Extra (flops, bytes) the reference adds for once-counted scan
    bodies."""
    if shape.kind == "decode":
        return {"flops": 0.0, "bytes": 0.0}
    b = shape.global_batch
    s = shape.seq_len
    if cfg.frontend == "vision":
        s = shape.seq_len  # patches included in backbone seq
    mult = 3.0 if shape.kind == "train" else 1.0   # bwd ~ 2x fwd
    flops = 0.0
    nbytes = 0.0
    reps = cfg.n_periods
    if s >= CHUNKED_ATTN_MIN_SEQ and s % CHUNK_KV == 0:
        n_chunks = s // CHUNK_KV
        attn_reps = sum(1 for bk in cfg.period
                        if bk.mixer == "attn") * reps
        if cfg.is_encdec:
            attn_reps += cfg.n_encoder_layers
        hd = cfg.n_heads * cfg.d_head
        attn_f = 4.0 * b * s * s * hd * (0.5 if cfg.causal else 1.0)
        # scan carries (m, l, acc) rewritten per chunk
        carry_b = b * s * cfg.n_heads * (cfg.d_head + 2) * 4 * 2
        flops += attn_reps * attn_f * (n_chunks - 1) / n_chunks * mult
        nbytes += attn_reps * carry_b * (n_chunks - 1) * mult
    for blk in cfg.period:
        if blk.mixer == MIXER_MAMBA:
            L = ssm.MAMBA_CHUNK
            trips = s // L
            di, ds = cfg.mamba_d_inner, cfg.mamba_d_state
            body_f = 9.0 * b * L * di * ds
            body_b = 5.0 * b * L * di * ds * 4
            flops += reps * (trips - 1) * body_f * mult
            nbytes += reps * (trips - 1) * body_b * mult
        elif blk.mixer == MIXER_SLSTM:
            dp = int(cfg.xlstm_proj_factor * cfg.d_model)
            trips = s
            body_f = 8.0 * b * dp * dp + 12.0 * b * dp
            body_b = 6.0 * b * dp * 4
            flops += reps * (trips - 1) * body_f * mult
            nbytes += reps * (trips - 1) * body_b * mult
        elif blk.mixer == MIXER_MLSTM:
            L = min(ssm.MLSTM_CHUNK, s)
            trips = s // L
            dp = int(cfg.xlstm_proj_factor * cfg.d_model)
            dk = dp // cfg.n_heads
            h = cfg.n_heads
            body_f = b * h * L * L * (4 * dk + 8.0) + 4.0 * b * h * L * dk * dk
            body_b = (3.0 * b * L * dp + 2.0 * b * h * dk * dk) * 4
            flops += reps * (trips - 1) * body_f * mult
            nbytes += reps * (trips - 1) * body_b * mult
    return {"flops": flops / chips, "bytes": nbytes / chips}


# ---------------------------------------------------------------------------
# MODEL_FLOPS (useful-work floor, per device)
# ---------------------------------------------------------------------------

def model_flops(cfg: ModelConfig, shape: ShapeSpec, chips: int) -> float:
    n_active = cfg.param_count(active_only=True)
    attn_layers = sum(1 for bks in cfg.period
                      if bks.mixer == "attn") * cfg.n_periods
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        f = 6.0 * n_active * tokens
        f += 3 * 4 * shape.global_batch * shape.seq_len ** 2 \
            * cfg.n_heads * cfg.d_head * attn_layers / 2
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        f = 2.0 * n_active * tokens
        f += 4 * shape.global_batch * shape.seq_len ** 2 \
            * cfg.n_heads * cfg.d_head * attn_layers / 2
    else:  # decode: one token per sequence
        f = 2.0 * n_active * shape.global_batch
        f += 4 * shape.global_batch * shape.seq_len \
            * cfg.n_heads * cfg.d_head * attn_layers
    return f / chips


# ---------------------------------------------------------------------------
# record loading / extrapolation
# ---------------------------------------------------------------------------

def _load(arch: str, shape: str, mesh: str, tag: str = "") -> Optional[dict]:
    p = DRYRUN / f"{arch}__{shape}__{mesh}{tag}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _coll_bytes(rec: dict) -> float:
    return float(sum(v["bytes"] for v in rec.get("collectives", {}).values()))


def extrapolate_cell(arch: str, shape_name: str,
                     mesh: str = "16x16") -> Optional[dict]:
    """Combine full/u1/u2 dry-run records into roofline terms."""
    full = _load(arch, shape_name, mesh)
    u1 = _load(arch, shape_name, mesh, "u1")
    u2 = _load(arch, shape_name, mesh, "u2")
    if full is None or full["status"] != "ok":
        return full
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    chips = 256 if mesh == "16x16" else 512
    n_periods = cfg.n_periods

    if u1 and u2 and u1["status"] == u2["status"] == "ok":
        body_f = max(u2["flops"] - u1["flops"], 0.0)
        body_b = max(u2["bytes_accessed"] - u1["bytes_accessed"], 0.0)
        body_c = max(_coll_bytes(u2) - _coll_bytes(u1), 0.0)
        base_f = max(u1["flops"] - body_f, 0.0)
        base_b = max(u1["bytes_accessed"] - body_b, 0.0)
        base_c = max(_coll_bytes(u1) - body_c, 0.0)
        flops = base_f + n_periods * body_f
        nbytes = base_b + n_periods * body_b
        coll = base_c + n_periods * body_c
        method = "u1/u2 extrapolation"
    else:
        flops, nbytes, coll = (full["flops"], full["bytes_accessed"],
                               _coll_bytes(full))
        method = "full trace"

    corr = {"flops": 0.0, "bytes": 0.0}

    t_compute = flops / PEAK_FLOPS
    t_memory = nbytes / HBM_BW
    t_coll = coll / LINK_BW
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, chips)
    bound = max(terms.values())
    useful_frac = (mf / PEAK_FLOPS) / bound if bound > 0 else 0.0
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh,
        "method": f"{method}; {METHOD_NOTE}",
        "flops": flops, "bytes": nbytes, "collective_bytes": coll,
        "t_compute_s": t_compute, "t_memory_s": t_memory,
        "t_collective_s": t_coll, "dominant": dominant,
        "model_flops": mf, "useful_flops_ratio": mf / flops if flops else 0,
        "roofline_fraction": useful_frac,
        "memory_per_device": full.get("memory", {}),
        "scan_correction": corr,
    }


MITIGATIONS = {
    "compute": "raise MFU: larger per-chip tiles (less TP), fuse attention "
               "(flash kernel), drop remat recompute on cheap ops",
    "memory": "cut HBM traffic: fuse norms/elementwise into matmuls, bf16 "
              "activations end-to-end, avoid full-KV rewrites per step",
    "collective": "reshard: keep activations sequence-sharded through the "
                  "block (avoid boundary re-gathers), overlap collectives "
                  "with compute, int8-compress inter-node traffic",
}


def analyze_all(mesh: str = "16x16") -> list:
    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES, cell_applicable
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shp in SHAPES:
            ok, reason = cell_applicable(cfg, shp)
            if not ok:
                out.append({"arch": arch, "shape": shp.name, "mesh": mesh,
                            "status": "skipped", "reason": reason})
                continue
            rec = extrapolate_cell(arch, shp.name, mesh)
            if rec is not None:
                rec.setdefault("status", "ok")
                if rec.get("status") == "ok" and "dominant" in rec:
                    rec["mitigation"] = MITIGATIONS[rec["dominant"]]
                out.append(rec)
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "roofline.json").write_text(json.dumps(out, indent=1))
    return out


def markdown_table(records: list) -> str:
    hdr = ("| arch | shape | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
           "dominant | MODEL/HLO | roofline frac |\n"
           "|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in records:
        if r.get("status") == "skipped" or "t_compute_s" not in r:
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skipped | — | — |")
            continue
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['t_compute_s']*1e3:.2f} | "
            f"{r['t_memory_s']*1e3:.2f} | {r['t_collective_s']*1e3:.2f} | "
            f"{r['dominant']} | {r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2f} |")
    return hdr + "\n".join(rows)


if __name__ == "__main__":
    recs = analyze_all()
    print(markdown_table(recs))
