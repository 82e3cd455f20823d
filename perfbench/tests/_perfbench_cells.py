"""A benchmark root at smoke size for the benchmark's CPU tests: a copy of
the data under ``perfbench/`` and of ``BENCHMARK.json``, with a dense and
a MoE configuration cut to smoke widths, a short mix and their limit
files, added as new files and entries only."""
import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DATA = ("configs", "traffic", "metrics", "limits")
SMOKE = dict(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
             intermediate_size=128, vocab_size=256, num_hidden_layers=2)
LIMITS = {"max_logit_gap": 0.5, "logit_rel_err": 0.03}


def smoke_conf(src: str, dtype: str = "bfloat16", **over) -> dict:
    conf = json.loads((REPO / "perfbench" / "configs" / f"{src}.json")
                      .read_text())
    conf.update(SMOKE)
    if conf.get("num_local_experts"):
        conf["num_local_experts"] = 4
    conf["port"] = dict(conf["port"], head_dim=16, dtype=dtype)
    conf.update(over)
    return conf


def smoke_root(tmp: Path) -> Path:
    """A root holding the benchmark's data and two smoke cells,
    ``dense.smoke`` and ``moe.smoke``, that report every metric."""
    bench = tmp / "perfbench"
    bench.mkdir(parents=True)
    for sub in DATA:
        shutil.copytree(REPO / "perfbench" / sub, bench / sub)
    shutil.copy(REPO / "perfbench" / "peaks.json", bench)
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (bench / "traffic" / "smoke.json").write_text(json.dumps(dict(
        loop="closed", clients=1, requests=[{"ii": 12, "oo": 6, "bb": 3}])))
    for kind, src in (("dense", "qwen2.5-32b"), ("moe", "phi3.5-moe-l24")):
        (bench / "configs" / f"{kind}-smoke.json").write_text(
            json.dumps(smoke_conf(src)))
        (bench / "limits" / f"{kind}.smoke.json").write_text(
            json.dumps({n: {"limit": v} for n, v in LIMITS.items()}))
        spec["configs"].append(dict(
            name=f"{kind}-smoke", source="smoke", reduced=[], why="smoke",
            file=f"perfbench/configs/{kind}-smoke.json"))
        spec["workloads"].append(dict(
            name=f"{kind}.smoke", config=f"{kind}-smoke", traffic="smoke",
            chips=1, why="smoke"))
        for m in spec["per_layer"]:
            m["workloads"].append(f"{kind}.smoke")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp
