"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on one
rank of the production mesh, with nothing allocated and no card: the
reference package's ``launch/dryrun.py`` on ``torch.distributed``.

Proves the distribution config is coherent without hardware: the step of
the production mesh must run under the sharding policy as rank 0 of a
fake process group of 256 (or 512) ranks, on meta tensors placed by the
policy over a mesh of device type "cuda", so the card's path runs: the
kernels K1-K3 are ``repro_torch`` ops whose shape-only forms stand for
the launches, and collectives go to the fake group, which moves nothing.
``launch/cost.py::StepCost`` records per-device FLOPs, bytes, memory and
collectives.  Records go to ``results/torch/dryrun/*.json``, so the
sweep is resumable (one process per cell via --arch/--shape, or an
in-process sweep with --all).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
      --shape train_4k [--multi-pod] [--no-collectives]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
  PYTHONPATH=src python -m repro_torch.launch.dryrun --roofline
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, cell_applicable, get_shape
from repro_torch.distributed.compat import cost_analysis_dict
from repro_torch.distributed.sharding import ShardingPolicy
from repro_torch.launch.cost import StepCost, storage_bytes
from repro_torch.launch.mesh import data_axes_of, make_production_mesh
from repro_torch.launch.steps import build_step, place, sharded_step
from repro_torch.models.transformer import Model

RESULTS = pathlib.Path(__file__).resolve().parents[3] / "results" / "torch" \
    / "dryrun"

# the share of a chip's HBM the reference's hillclimb lets weights take:
# 11e9 of a 16 GB chip; the same 11/16 of the H100's 80 GB
HBM_BUDGET = 80e9 * 11 / 16

METHOD = (
    "one rank's eager step over meta tensors (torch.distributed fake "
    "group, DeviceMesh of device type cuda, K1-K3 as repro_torch ops' "
    "shape-only forms); flops: FlopCounterMode's formulas and the "
    "kernels' own over the local ops only (no DTensor-level op, no "
    "sharding-propagation op), every trip of every loop counted; "
    "bytes_accessed: operand and result bytes of every local op that "
    "moves data, views and metadata ops zero (eager and unfused: an upper "
    "bound on HBM traffic); memory: arguments' local storages, results "
    "other than a donated argument's update (train: parameters and "
    "optimizer state; decode: the cache) not aliasing an argument, temp = "
    "peak live storage less the arguments; lower_s: building the model and "
    "the policy, compile_s: building, placing and tracing the step")


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks, this process rank
    ``rank``, destroyed on exit; its collectives move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world needs no process group initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# a step's results that update a donated argument (train: params and
# optimizer state, decode: the cache), as the reference donates them
DONATED = {"train": (0, 1), "decode": (1,), "prefill": ()}


def trace_step(model: Model, policy: ShardingPolicy, shape):
    """Traces ``build_step(model, policy, shape)`` once on meta tensors;
    returns (``StepCost``, its memory record).  The model takes the
    placed parameters (trainable for a train shape), as a step's caller
    holds them.  A result that updates a donated argument is no output:
    the reference's step writes it over the argument's buffers."""
    step, in_sh, out_sh, args = build_step(model, policy, shape)
    placed = place(args, in_sh)        # meta shards: nothing allocated
    model.load(placed[0], train=shape.kind == "train")
    placed = (dict(model.named_parameters()), *placed[1:])
    run = sharded_step(policy, step, in_sh, out_sh)
    args_st = storage_bytes(placed)
    cost = StepCost()
    held = cost.hold(placed)
    with cost:
        out = run(*placed)
    donated = DONATED[shape.kind]
    out_st = storage_bytes([o for i, o in enumerate(out) if i not in donated])
    memory = {
        "argument_size_in_bytes": held,
        "output_size_in_bytes": sum(n for k, n in out_st.items()
                                    if k not in args_st),
        "temp_size_in_bytes": cost.peak - held,
    }
    return cost, memory


def hillclimb(cfg, serving: bool, tp: int, hbm_budget: float = HBM_BUDGET):
    """(serving_2d, cp): the reference's two hillclimbed choices
    (``launch/dryrun.py:112-137`` there) for ``cfg`` on a model axis of
    ``tp`` ranks under ``hbm_budget`` bytes of weights a chip."""
    # hillclimb #1: TP-only weights whenever they fit per-chip HBM —
    # 2D (data x model) weight sharding costs a full weight all-gather
    # per step and is reserved for models too big for TP alone.
    serving_2d = cfg.param_count() * 2 / tp > hbm_budget
    # hillclimb #2: context-parallel serving for archs whose head
    # count doesn't divide the TP width (replicate block weights over
    # model, shard the sequence end-to-end) — only when the replicated
    # weights actually fit alongside activations.
    cp = (serving and not cfg.attention_free
          and cfg.n_heads % tp != 0
          and cfg.param_count() * 2 <= 0.6 * hbm_budget)
    return serving_2d, cp


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             collectives: bool = True, unroll_periods: int = 0,
             save: bool = True, policy_mode: str = "auto") -> dict:
    """Traces one cell as rank 0 of a fake group; returns the record.

    ``policy_mode``: "auto" applies the hillclimbed sharding policy
    (TP-only serving weights when they fit, context-parallel serving for
    non-divisible head counts, expert-parallel MoE); "baseline" pins the
    paper-faithful pre-hillclimb policy for §Perf A/B records.
    ``unroll_periods`` N traces a depth-N config (N periods, and N encoder
    layers), as the reference compiles its unrolled variants."""
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    ok, reason = cell_applicable(cfg, shape)
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "unroll_periods": unroll_periods, "policy": policy_mode}
    if not ok:
        rec.update(status="skipped", reason=reason)
        _save(rec, save)
        return rec

    t0 = time.time()
    try:
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cuda")
            serving = shape.kind != "train"
            tp = mesh.size(mesh.mesh_dim_names.index("model"))
            serving_2d, cp = hillclimb(cfg, serving, tp)
            if policy_mode == "baseline":
                policy = ShardingPolicy(mesh, data_axes=data_axes_of(mesh),
                                        serving=serving, serving_2d=True,
                                        cp_replicate_weights=False,
                                        ep_moe=False)
            else:
                policy = ShardingPolicy(mesh, data_axes=data_axes_of(mesh),
                                        serving=serving,
                                        serving_2d=serving_2d,
                                        cp_replicate_weights=cp)
            if serving:
                # inference holds bf16 weights, sharded across the slice
                cfg = cfg.scaled(param_dtype=torch.bfloat16)
            if unroll_periods:
                overrides = {"n_layers": len(cfg.period) * unroll_periods}
                if cfg.is_encdec:
                    overrides["n_encoder_layers"] = unroll_periods
                model = Model(cfg.scaled(**overrides))
            else:
                model = Model(cfg, remat=(shape.kind == "train"))
            t_lower = time.time() - t0
            cost, memory = trace_step(model, policy, shape)
            t_compile = time.time() - t0 - t_lower
        summary = cost_analysis_dict(cost)
        rec.update(
            status="ok",
            lower_s=round(t_lower, 2),
            compile_s=round(t_compile, 2),
            flops=summary["flops"],
            bytes_accessed=summary["bytes accessed"],
            memory=memory,
            method=METHOD,
        )
        if collectives:
            rec["collectives"] = cost.collectives
        print(f"[dryrun] OK {arch} {shape_name} mesh={rec['mesh']} "
              f"lower={t_lower:.1f}s trace={t_compile:.1f}s "
              f"flops={rec['flops']:.3g}")
        print("  memory:", rec["memory"])
    except Exception as e:  # noqa: BLE001 — record the failure
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[dryrun] FAIL {arch} {shape_name}: {rec['error']}")
    _save(rec, save)
    return rec


def record_name(rec: dict) -> str:
    tag = "u%d" % rec["unroll_periods"] if rec.get("unroll_periods") else ""
    if rec.get("policy") == "baseline":
        tag += "__pbase"
    name = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    return name.replace("/", "_")


def _save(rec: dict, save: bool):
    if not save:
        return
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / record_name(rec)).write_text(json.dumps(rec, indent=1))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=[s.name for s in SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--unroll-periods", type=int, default=0,
                    help="trace a depth-N variant (roofline)")
    ap.add_argument("--no-collectives", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="trace u1+u2 variants for every applicable "
                         "single-pod cell")
    ap.add_argument("--policy", choices=("auto", "baseline"),
                    default="auto")
    args = ap.parse_args()

    if args.roofline:
        n_fail = 0
        for arch in ARCHS:
            for shape in SHAPES:
                for u in (1, 2):
                    rec = run_cell(arch, shape.name, multi_pod=False,
                                   collectives=True, unroll_periods=u,
                                   policy_mode=args.policy)
                    n_fail += rec["status"] == "error"
        print(f"[dryrun] roofline sweep done fail={n_fail}")
        raise SystemExit(1 if n_fail else 0)

    if args.all:
        n_ok = n_skip = n_fail = 0
        for multi_pod in (False, True):
            for arch in ARCHS:
                for shape in SHAPES:
                    rec = run_cell(arch, shape.name, multi_pod=multi_pod,
                                   collectives=not args.no_collectives,
                                   policy_mode=args.policy)
                    n_ok += rec["status"] == "ok"
                    n_skip += rec["status"] == "skipped"
                    n_fail += rec["status"] == "error"
        print(f"[dryrun] sweep done ok={n_ok} skip={n_skip} fail={n_fail}")
        raise SystemExit(1 if n_fail else 0)

    assert args.arch and args.shape, "--arch/--shape or --all"
    rec = run_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                   collectives=not args.no_collectives,
                   unroll_periods=args.unroll_periods,
                   policy_mode=args.policy)
    raise SystemExit(0 if rec["status"] in ("ok", "skipped") else 1)


if __name__ == "__main__":
    main()
