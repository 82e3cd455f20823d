"""One run of one cell: set-up, the measured window, an optional traced
request, the check, and the result line.

Everything that belongs to one cell is found by name from
``BENCHMARK.json``: the workload names its configuration file and its
traffic mix (``perfbench/traffic/<traffic>.json``), its limit file is
``perfbench/limits/<workload>.json``, and each metric is read by
``perfbench/metrics/<metric>.py``, whose ``read(run)`` returns the value
or None where it finds nothing to read.  From the program the harness takes
only the system under test: the model (``Model.load``, ``param_structs``
for the names and shapes it takes), the serving engine and its timers,
the compile counter, and the kernels' names in a trace.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

from perfbench import check, counts, devtrace, weights as draws
from perfbench.workload import Mix

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that cannot give a result."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# -- the cell, from BENCHMARK.json and the files it names ---------------------

@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def _reports(entry: dict, cell: str, e2e_names) -> bool:
    if "workloads" in entry:
        return cell in entry["workloads"]
    return entry.get("moves", entry["name"]) in e2e_names


def load_cell(root: Path, workload: str) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise RunError(f"unknown workload {workload!r}; known: "
                       f"{sorted(cells)}")
    w = cells[workload]
    conf_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, workload, names)]
    bench = root / "perfbench"
    return Cell(
        name=workload, chips=w["chips"],
        config=json.loads((root / conf_entry["file"]).read_text()),
        traffic=json.loads((bench / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        end_to_end=e2e, per_layer=per_layer,
        limits=json.loads((bench / "limits" / f"{workload}.json")
                          .read_text()))


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``perfbench/metrics/<metric>.py``."""
    path = root / "perfbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# -- the program ---------------------------------------------------------------

def model_config(conf: dict):
    """The port's ModelConfig of a configuration file: the port's arch,
    every size and option the file states put over it.  A published key
    that the port would run otherwise is refused: the file states what
    runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.config import (FFN_DENSE, FFN_MOE, BlockSpec)
    port = conf["port"]
    for key, runs in (("attention_bias", port["qkv_bias"]),
                      ("lm_head_bias", False)):
        if conf.get(key, runs) != runs:
            raise RunError(f"{conf['name']}: the file states {key} "
                           f"{conf[key]}, the port runs {runs}")
    moe = port["ffn"] == "moe"
    fields = dict(
        n_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        n_heads=conf["num_attention_heads"],
        n_kv_heads=conf["num_key_value_heads"], d_head=port["head_dim"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        rope_theta=conf["rope_theta"], norm_eps=conf["rms_norm_eps"],
        tie_embeddings=conf["tie_word_embeddings"],
        qkv_bias=port["qkv_bias"], qk_norm=False, causal=True,
        sliding_window=None, n_encoder_layers=0, frontend="none",
        vocab_pad_multiple=port["vocab_pad_multiple"],
        compute_dtype=getattr(torch, port["dtype"]),
        param_dtype=torch.float32,
        period=(BlockSpec(ffn=FFN_MOE if moe else FFN_DENSE),),
        n_experts=conf["num_local_experts"] if moe else 0,
        top_k=conf["num_experts_per_tok"] if moe else 0,
        moe_d_ff=conf["intermediate_size"] if moe else 0,
        capacity_factor=port.get("capacity_factor", 1.25))
    return dataclasses.replace(get_config(port["arch"]), **fields)


def build(conf: dict, seed: int, device):
    """(model, the weights it holds, their digest): drawn from ``seed`` on
    ``device`` by the benchmark, with the names and shapes ``Model.load``
    takes, and digested before the program sees them."""
    from repro_torch.models.transformer import Model, param_structs
    cfg = model_config(conf)
    structs = {n: (tuple(t.shape), t.dtype)
               for n, t in param_structs(cfg).items()}
    weights = draws.draw(structs, conf["init"], seed, device)
    digest = draws.digest(weights)
    return Model(cfg).load(weights), weights, digest


class Held:
    """The logits that the timed path leaves, as the model returns them:
    the prefill's, at the prompt's last position, and the decode step's
    (under a CUDA graph the captured step's output, which each replay
    rewrites, so after a request it holds the last step's)."""

    def __init__(self, model):
        self.prefill = self.step = None
        prefill, step = model.prefill, model.decode_step

        def keep_prefill(*args, **kwargs):
            logits, cache = prefill(*args, **kwargs)
            self.prefill = logits
            return logits, cache

        def keep_step(*args, **kwargs):
            logits, cache = step(*args, **kwargs)
            self.step = logits
            return logits, cache
        model.prefill, model.decode_step = keep_prefill, keep_step

    def take(self, vocab: int, oo: int):
        """(B, 2, vocab) on the host: the prefill's row and the last step's
        (the prefill's alone where ``oo`` is 1)."""
        import torch
        rows = [self.prefill] + ([self.step] if oo > 1 else [])
        out = torch.cat([r[:, -1:, :vocab] for r in rows], 1).cpu()
        self.prefill = None
        return out


def _compiles() -> Dict[str, int]:
    from repro_torch.compiles import COUNTS
    return dict(COUNTS)


def serve(engine, req, oo: Optional[int] = None,
          held: Optional[Held] = None) -> dict:
    """One request through ``ServingEngine.generate`` (with ``oo``, cut to
    that many new tokens, in the same cache): its record, with the logits
    ``held`` kept."""
    sh = req.shape
    oo = oo or sh.oo
    vocab = engine.model.cfg.vocab_size
    t0 = time.perf_counter()
    res = engine.generate(req.prompts, oo, max_len=sh.max_len)
    t1 = time.perf_counter()
    toks = res.tokens
    ok = (toks.shape == (sh.bb, oo)
          and bool(((toks >= 0) & (toks < vocab)).all()))
    return dict(ii=sh.ii, oo=oo, bb=sh.bb, t0=t0, t1=t1,
                prefill_s=res.prefill_s, decode_s=res.decode_s,
                prompts=req.prompts, tokens=toks, ok=ok,
                logits=held.take(vocab, oo) if held else None)


def window(engine, mix: Mix, seconds: float, held: Held) -> List[dict]:
    """Requests back to back while the window is open; each request
    started in it runs whole."""
    records = []
    start = time.perf_counter()
    for req in mix.requests():
        if time.perf_counter() - start >= seconds:
            break
        records.append(serve(engine, req, held=held))
    return records


# -- what the readers get -------------------------------------------------------

@dataclasses.dataclass
class Run:
    sizes: counts.Sizes
    records: List[dict]
    setup_s: float
    memory_peak_bytes: Optional[int]
    peaks: Optional[dict]
    traced: Optional[dict] = None
    trace: Optional[devtrace.Trace] = None


def _card(device) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return dict(platform="cpu", kind="cpu", power="none")
    try:
        power = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        power = "unknown"
    return dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                power=power)


def _num(x: float):
    return x if math.isfinite(x) else str(x)


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device, started: float,
             controls: bool = False) -> dict:
    """One run of ``workload``; returns the result line's object (with
    ``controls``, the check also reads each control, under ``compared``,
    and judges it as it judges the program, under ``controls_correct``)."""
    import torch
    from repro_torch.inference.engine import ServingEngine
    t_import = time.time() - started
    cell = load_cell(root, workload)
    cuda = torch.device(device).type == "cuda"
    card = _card(device)
    t_card = time.time() - started
    peaks = json.loads((root / "perfbench" / "peaks.json").read_text()
                       ).get(card["kind"])
    log(f"[perfbench] {workload} seed {seed}: {card['kind']}, power limit "
        f"{card['power']}; peaks "
        + (f"{peaks['bf16_flops_s']:.4g} FLOP/s bf16, "
           f"{peaks['hbm_bytes_s']:.4g} B/s ({peaks['source']})"
           if peaks else "none for this device"))
    conf = cell.config
    t0 = time.perf_counter()
    model, weights, digest = build(conf, seed, device)
    held = Held(model)
    if cuda:
        torch.cuda.synchronize()
    t_draw = time.perf_counter() - t0
    engine = ServingEngine(model, device=device)
    mix = Mix(cell.traffic, conf["vocab_size"], seed)
    t1 = time.perf_counter()
    serve(engine, mix.warmup(), min(2, mix.shape.oo))
    if cuda:
        torch.cuda.synchronize()
    t_warm = time.perf_counter() - t1
    before = _compiles()
    setup_s = time.time() - started
    records = window(engine, mix, seconds, held)
    if _compiles() != before:
        raise RunError(f"{workload}: compilations inside the window: "
                       f"{before} before, {_compiles()} after")
    peak = torch.cuda.max_memory_allocated() if cuda else None
    span = records[-1]["t1"] - records[0]["t0"]
    log("[perfbench] requests (prefill s, decode s): " + ", ".join(
        f"{r['prefill_s']:.4f} {r['decode_s']:.4f}" for r in records))
    log(f"[perfbench] set-up {setup_s:.3f} s (imports done at "
        f"{t_import:.3f} s, the card read at {t_card:.3f} s, weights drawn "
        f"in {t_draw:.3f} s, warm-up {t_warm:.3f} s); window: "
        f"{len(records)} requests in {span:.3f} s")
    run = Run(counts.Sizes.of(conf), records, setup_s, peak, peaks)
    if trace:
        req = next(mix.requests())
        t3 = time.perf_counter()
        run.trace, run.traced = devtrace.trace(
            lambda: serve(engine, req, min(2, req.shape.oo)),
            lambda: serve(engine, req), device)
        if _compiles() != before:
            raise RunError(f"{workload}: compilations in the traced "
                           f"request: {before} before, {_compiles()} after")
        log(f"[perfbench] traced request: {len(run.trace.device)} device "
            f"events, traced and read in {time.perf_counter() - t3:.3f} s")
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = reader(root, m["name"])(run)
        if value is None:
            log(f"[perfbench] {m['name']}: nothing to read, left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    failed = sum(not r["ok"] for r in records)
    del engine, model, held
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t2 = time.perf_counter()
    moved = draws.changed(weights, digest)
    read = check.compare(conf, weights, records, mix.sample_rng(), device,
                         controls)
    log(f"[perfbench] check: {time.perf_counter() - t2:.3f} s")
    limits = {n: cell.limits[n]["limit"] for n in check.NUMBERS}
    correct = (failed == 0 and moved == 0 and read is not None
               and check.within(read["program"], limits))
    dev = dict(platform=card["platform"], kind=card["kind"],
               count=cell.chips, memory_peak_bytes=peak)
    out = dict(correct=correct, attempted=len(records), failed=failed,
               metrics=metrics, device=dev)
    if trace:
        dev.update(busy_s=run.trace.busy_s(), window_s=run.trace.window_s)
        out["breakdown"] = run.trace.breakdown()
    if controls:
        out["controls_correct"] = {side: check.within(nums, limits)
                                   for side, nums in (read or {}).items()
                                   if side != "program"}
    compared = {"weights_changed": {"value": moved, "limit": 0}}
    for side, nums in (read or {}).items():
        for n, v in nums.items():
            key = n if side == "program" else f"{side}.{n}"
            compared[key] = {"value": _num(v), "limit": limits[n]}
    out["compared"] = compared
    for name, c in compared.items():
        log(f"compared {name} {c['value']} limit {c['limit']}")
    return out


# -- the command -----------------------------------------------------------------

def loaded_forbidden() -> List[str]:
    return sorted(n for n in sys.modules if n.split(".")[0] in FORBIDDEN)


def main(argv, root: Path, started: float) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    cell = load_cell(root, args.workload)
    if not torch.cuda.is_available():
        log("perfbench: no CUDA device; the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"perfbench: {args.workload} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found")
        return 2
    result = run_cell(root, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", started)
    bad = loaded_forbidden()
    if bad:
        log(f"perfbench: loaded in this process: {', '.join(bad)}")
        return 3
    print(json.dumps(result), flush=True)
    return 0
