"""Generate ``results/torch/EXPERIMENTS.md`` from the port's results
(the dry run's records, ``roofline.json``, ``perf_report.json``); the
reference package's ``analysis/experiments_doc.py``."""
from __future__ import annotations

import json

from repro_torch.analysis import roofline as R
from repro_torch.analysis.perf_report import CELLS, report as perf_table

RESULTS = R.RESULTS


def _bench():
    p = RESULTS / "bench_report.json"
    return json.loads(p.read_text()) if p.exists() else {}


def dryrun_section() -> str:
    recs = []
    for p in sorted((RESULTS / "dryrun").glob("*.json")):
        if "u1" in p.name or "u2" in p.name or "pbase" in p.name:
            continue
        recs.append(json.loads(p.read_text()))
    ok = [r for r in recs if r["status"] == "ok"]
    skip = [r for r in recs if r["status"] == "skipped"]
    fail = [r for r in recs if r["status"] == "error"]
    lines = [
        f"Cells traced: **{len(ok)} ok / {len(skip)} skipped / "
        f"{len(fail)} failed** across meshes 16x16 (256 ranks) and "
        f"2x16x16 (512 ranks, multi-pod).",
        "",
        "Skips are the assignment-mandated `long_500k` cells for pure "
        "full-attention archs (dense-KV 512k decode out of scope); the "
        "sub-quadratic archs (jamba-1.5-large, xlstm-125m) run it.",
        "",
        "| arch | shape | mesh | trace_s | flops/dev | "
        "args GB/dev | temp GB/dev |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(ok, key=lambda r: (r["arch"], r["shape"], r["mesh"])):
        m = r.get("memory", {})
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{r.get('compile_s', 0):.1f} | {r['flops']:.3g} | "
            f"{m.get('argument_size_in_bytes', 0)/1e9:.2f} | "
            f"{m.get('temp_size_in_bytes', 0)/1e9:.2f} |")
    if fail:
        lines.append("\nFailures:\n")
        for r in fail:
            lines.append(f"* {r['arch']} {r['shape']} {r['mesh']}: "
                         f"{r['error']}")
    return "\n".join(lines)


def roofline_section() -> str:
    recs = R.analyze_all()
    table = R.markdown_table(recs)
    doms = {}
    for r in recs:
        if "dominant" in r:
            doms[r["dominant"]] = doms.get(r["dominant"], 0) + 1
    notes = [
        "",
        f"Dominant-term census: {doms}.",
        "",
        "Per-cell one-line mitigations are in `results/torch/roofline.json` "
        "(`mitigation` field); the three §Perf cells act on them.",
    ]
    return table + "\n" + "\n".join(notes)


HEADER = """# EXPERIMENTS (PyTorch/CUDA port)

All numbers regenerate with:

```
PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # §Dry-run
PYTHONPATH=src python -m repro_torch.launch.dryrun --roofline     # §Roofline inputs
PYTHONPATH=src python -m repro_torch.launch.dryrun --roofline --policy baseline
PYTHONPATH=src python -m repro_torch.analysis.experiments_doc     # this file
```

(§Perf also reads each cell's full-depth baseline record:
`--arch A --shape S --policy baseline`.)

Hardware model: one NVIDIA H100 SXM a rank, 80 GB HBM3 at a 700 W limit:
989 TFLOP/s dense bf16, 3.35 TB/s HBM, 50 GB/s a link (one 400 Gb/s NDR
NIC a GPU, the slowest link a 16-wide axis of 8-GPU nodes crosses), from
the datasheet. The dry run needs no card: each cell's step runs as rank 0
of a fake process group over meta tensors, the kernels as shape-only ops;
its terms derive from that rank's counted local ops.
"""

DATASETS = """## §Datasets

* `inhouse` — 4,800 points of the roofline simulator's LLaMA-3.1-8B
  serving grid (8 input sizes x 6 output sizes x 10 batch sizes x 10
  noisy repetitions), made anew by `repro_torch.bench.datasets`.
* `suite` — all 11 archs x 3 serving frameworks x (bb 1-64, ii/oo
  128-2048) x 3 reps, from the same simulator.
* `mismatch` — qwen3-0.6b on a `legacy-gpu` profile: the RQ4
  hardware-mismatch case.
* real-measurement path: `repro_torch.bench.harness.measure_arch` times
  the port's engine on the card (`chip_smoke.py` phases [8] and [10]).
"""


def paper_validation_section() -> str:
    b = _bench()
    out = ["## §Paper-validation (RQ1-RQ4)", ""]
    if not b:
        out += ["No `results/torch/bench_report.json` yet: the port's "
                "benchmark is to come.", ""]
    if "fig2" in b:
        out += [
            f"**Alg 2 fit quality (Fig 2)** — {b['fig2']['db_groups']} "
            f"(ii,oo) groups fitted in {b['fig2']['fit_db_s']:.2f}s "
            f"(batched LM); train median APE "
            f"{b['fig2']['train_median_ape']:.2f}%.", ""]
    if "fig3" in b:
        out += [
            f"**Alg 3 extrapolation (Fig 3)** — params predicted for "
            f"{b['fig3']['held_groups']} fully held-out (ii,oo) groups: "
            f"median APE {b['fig3']['unseen_median_ape']:.2f}%.", ""]
    for key, title in (("fig6_rq1", "RQ1 (Figs 5-6): training-set "
                                    "composition"),
                       ("fig8_rq3", "RQ3 (Fig 8): per-architecture "
                                    "generalization")):
        if key in b:
            out += [f"**{title}**", "", "| experiment | median APE | p90 |",
                    "|---|---|---|"]
            for k, v in sorted(b[key].items()):
                out.append(f"| {k} | {v['median']:.2f}% | "
                           f"{v['p90']:.1f}% |")
            out.append("")
    if "table1_rq4" in b:
        out += ["**RQ4 (Table I): uncertainty quantification**", "",
                "| dataset | predicted error | confidence | actual error |",
                "|---|---|---|---|"]
        for k, v in b["table1_rq4"].items():
            out.append(f"| {k} | {v['predicted_error']:.2f}% | "
                       f"{v['confidence']:.2f} | "
                       f"{v['actual_error']:.2f}% |")
        out.append("")
    return "\n".join(out)


def perf_section() -> str:
    return "\n".join([
        "## §Perf — the policy's three hillclimbed choices",
        "",
        "The reference's three cells, each traced under the baseline "
        "policy (2D serving weights, no context parallelism, replicated "
        "MoE dispatch) and the hillclimbed one:",
        "",
        *(f"* {arch} {shape}: {desc}." for arch, shape, desc in CELLS),
        "",
        perf_table(),
        "",
        "Bounds are per-device terms of one rank's counted local ops "
        "(`roofline`'s method); they predict, and no card measured them.",
    ])


def main():
    doc = "\n\n".join([
        HEADER,
        DATASETS,
        paper_validation_section(),
        "## §Dry-run\n\n" + dryrun_section(),
        "## §Roofline\n\n"
        "Method: the eager trace counts every op of one rank, every trip "
        "of every loop, so per-period costs come from depth-1/2 traces "
        "(`--unroll-periods`), extrapolated to full depth, with no "
        "inner-scan correction. Terms are per-device seconds.\n\n"
        + roofline_section(),
        perf_section(),
    ])
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "EXPERIMENTS.md").write_text(doc)
    print(f"wrote {RESULTS / 'EXPERIMENTS.md'} ({len(doc)} chars)")


if __name__ == "__main__":
    main()
