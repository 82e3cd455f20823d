"""§Perf report: baseline vs hillclimbed policy for the three chosen
cells, from the dry run's A/B records; the reference package's
``analysis/perf_report.py``."""
from __future__ import annotations

import json
import pathlib

from repro_torch.analysis.roofline import (HBM_BW, LINK_BW, PEAK_FLOPS,
                                           RESULTS, _coll_bytes, _load)

CELLS = [
    ("qwen2.5-32b", "decode_32k",
     "hillclimb #1: TP-only serving weights (no per-step weight gather)"),
    ("llama3.2-3b", "prefill_32k",
     "hillclimb #2: context-parallel prefill (heads % TP != 0)"),
    ("llama4-maverick-400b-a17b", "train_4k",
     "hillclimb #3: expert-parallel MoE dispatch (shard_map)"),
]


def _terms(arch, shape, tag):
    """Roofline terms for a record set (full + u1/u2 with given tag).  No
    scan correction, in either policy: the eager trace counts every trip
    (``roofline``'s docstring)."""
    full = _load(arch, shape, "16x16", tag)
    u1 = _load(arch, shape, "16x16", "u1" + tag)
    u2 = _load(arch, shape, "16x16", "u2" + tag)
    if not full or full.get("status") != "ok":
        return None
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    n_periods = cfg.n_periods
    if u1 and u2 and u1["status"] == u2["status"] == "ok":
        bf = max(u2["flops"] - u1["flops"], 0.0)
        bb = max(u2["bytes_accessed"] - u1["bytes_accessed"], 0.0)
        bc = max(_coll_bytes(u2) - _coll_bytes(u1), 0.0)
        flops = max(u1["flops"] - bf, 0.0) + n_periods * bf
        nbytes = max(u1["bytes_accessed"] - bb, 0.0) + n_periods * bb
        coll = max(_coll_bytes(u1) - bc, 0.0) + n_periods * bc
    else:
        flops, nbytes, coll = (full["flops"], full["bytes_accessed"],
                               _coll_bytes(full))
    return {"flops": flops, "bytes": nbytes, "coll": coll,
            "t_compute": flops / PEAK_FLOPS, "t_memory": nbytes / HBM_BW,
            "t_collective": coll / LINK_BW,
            "mem": full.get("memory", {})}


def obs_scorecard(path) -> str:
    """The serving-observability scorecard from an ``obs_engine`` result
    file at ``path`` (``{"meta", "per_tenant", "calibration"}``), or ""
    without one.  Rendering lives in ``repro_torch.obs.export``; this is
    just the report glue."""
    if path is None or not pathlib.Path(path).exists():
        return ""
    from repro_torch.obs.export import scorecard_markdown
    path = pathlib.Path(path)
    bench = json.loads(path.read_text())
    title = f"Serving observability scorecard ({path.name})"
    return scorecard_markdown(bench.get("meta", {}),
                              bench.get("per_tenant", {}),
                              bench.get("calibration"), title=title)


def report(obs_path=None) -> str:
    lines = ["| cell | policy | t_comp (ms) | t_mem (ms) | t_coll (ms) | "
             "dominant | bound (ms) |",
             "|---|---|---|---|---|---|---|"]
    summary = {}
    for arch, shape, desc in CELLS:
        for tag, name in (("__pbase", "baseline"), ("", "optimized")):
            t = _terms(arch, shape, tag)
            if t is None:
                lines.append(f"| {arch}/{shape} | {name} | (missing) | | | | |")
                continue
            terms = {"compute": t["t_compute"], "memory": t["t_memory"],
                     "collective": t["t_collective"]}
            dom = max(terms, key=terms.get)
            lines.append(
                f"| {arch}/{shape} | {name} | {t['t_compute']*1e3:.2f} | "
                f"{t['t_memory']*1e3:.2f} | {t['t_collective']*1e3:.2f} | "
                f"{dom} | {max(terms.values())*1e3:.2f} |")
            summary.setdefault(f"{arch}/{shape}", {})[name] = {
                **{k: v for k, v in t.items() if k != "mem"},
                "dominant": dom, "bound_s": max(terms.values())}
    RESULTS.mkdir(parents=True, exist_ok=True)
    (RESULTS / "perf_report.json").write_text(json.dumps(summary, indent=1))
    for cell, d in summary.items():
        if "baseline" in d and "optimized" in d:
            sp = d["baseline"]["bound_s"] / max(d["optimized"]["bound_s"],
                                                1e-12)
            lines.append(f"\n**{cell}**: step-bound "
                         f"{d['baseline']['bound_s']*1e3:.1f} ms -> "
                         f"{d['optimized']['bound_s']*1e3:.1f} ms "
                         f"(x{sp:.1f})")
    card = obs_scorecard(obs_path)
    if card:
        lines.append("\n" + card)
    return "\n".join(lines)


if __name__ == "__main__":
    print(report())
