"""The harness driven end to end on the CPU at smoke size, the look for a
card skipped: sound runs come out correct; each fault a serving cell can
have, planted under the timed path, comes out not correct, and so does a
program that writes to the weights the reference reads; a cell, a traffic
mix and a per-layer metric are added as new files and entries alone; a
configuration file that states what the port does not run, and a mix the
engine cannot serve, are refused; and the command refuses to run without
a card or without the program."""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from _perfbench_cells import LIMITS, REPO, smoke_root
from perfbench import harness
from perfbench.workload import Mix

SEED = 2 ** 31 + 11   # the driver's seeds pass 32 signed bits


def _run(root, cell, trace=False, seconds=0.2):
    return harness.run_cell(root, cell, SEED, seconds, trace, "cpu",
                            time.time())


@pytest.mark.parametrize("cell", ["dense.smoke", "moe.smoke"])
def test_a_sound_run_is_correct(tmp_path, cell):
    out = _run(smoke_root(tmp_path), cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == {"out_tok_s", "ttft_ms", "setup_s"}
    assert list(out)[-1] == "compared"
    c = out["compared"]
    assert set(c) == {"weights_changed", "max_logit_gap", "logit_rel_err"}
    assert c["weights_changed"]["value"] == 0
    for n in ("max_logit_gap", "logit_rel_err"):
        assert 0 <= c[n]["value"] <= c[n]["limit"]


def _token_altered(monkeypatch):
    """A served token altered where the engine samples it."""
    from repro_torch.inference import engine
    orig = engine.sample

    def altered(logits, *args, **kwargs):
        tok = orig(logits, *args, **kwargs)
        tok[0] = (tok[0] + 1) % logits.shape[-1]
        return tok
    monkeypatch.setattr(engine, "sample", altered)


def _state_unchanged(monkeypatch):
    """A decode step that leaves the cache as it was (K/V not written)."""
    from repro_torch.models import attention
    monkeypatch.setattr(attention, "write_at", lambda *args: None)


def _half_batch(monkeypatch):
    """Half of each batch left out, the rest's answers served for it."""
    from repro_torch.inference.engine import ServingEngine
    orig = ServingEngine.generate

    def half(self, prompts, n, **kwargs):
        b = prompts.shape[0]
        res = orig(self, prompts[:(b + 1) // 2], n, **kwargs)
        toks = np.concatenate([res.tokens, res.tokens])[:b]
        return dataclasses.replace(res, tokens=toks)
    monkeypatch.setattr(ServingEngine, "generate", half)


FAULTS = {"token_altered": _token_altered,
          "state_unchanged": _state_unchanged,
          "half_batch": _half_batch}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", ["dense.smoke", "moe.smoke"])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, monkeypatch,
                                                     cell, fault):
    root = smoke_root(tmp_path)
    FAULTS[fault](monkeypatch)
    out = _run(root, cell)
    assert not out["correct"]
    c = out["compared"]
    assert any(float(c[n]["value"]) > c[n]["limit"]
               for n in ("max_logit_gap", "logit_rel_err"))


@pytest.mark.parametrize("cell", ["dense.smoke", "moe.smoke"])
def test_weights_written_by_the_program_are_not_correct(tmp_path,
                                                        monkeypatch, cell):
    """A load that rounds the matrices it takes in place: the reference
    would read the program's weights and follow it."""
    from repro_torch.models.transformer import Model
    orig = Model.load

    def rounding(self, params, *args, **kwargs):
        for t in params.values():
            if t.dim() == 2:
                t.copy_(t.to(torch.float8_e4m3fn))
        return orig(self, params, *args, **kwargs)
    monkeypatch.setattr(Model, "load", rounding)
    out = _run(smoke_root(tmp_path), cell)
    assert not out["correct"]
    assert out["compared"]["weights_changed"]["value"] > 0


def test_a_cell_mix_and_metric_are_added_as_files_alone(tmp_path):
    """A new configuration, mix and per-layer metric: new files under
    configs/, traffic/, limits/ and metrics/, and entries in
    BENCHMARK.json; no other file changes."""
    root = smoke_root(tmp_path)
    bench = root / "perfbench"
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return len(run.records)\n")
    (bench / "traffic" / "long.json").write_text(json.dumps(dict(
        loop="closed", clients=1, requests=[{"ii": 16, "oo": 3, "bb": 2}])))
    conf = json.loads((bench / "configs" / "moe-smoke.json").read_text())
    conf["num_local_experts"] = 8
    (bench / "configs" / "moe8-smoke.json").write_text(json.dumps(conf))
    (bench / "limits" / "moe8.long.json").write_text(
        json.dumps({n: {"limit": v} for n, v in LIMITS.items()}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(name="moe8-smoke", source="smoke",
                                file="perfbench/configs/moe8-smoke.json",
                                reduced=[], why="smoke"))
    spec["workloads"].append(dict(name="moe8.long", config="moe8-smoke",
                                  traffic="long", chips=1, why="smoke"))
    spec["per_layer"].append(dict(name="requests_done", unit="requests",
                                  better="higher", source="program_counter",
                                  layer="engine", moves="out_tok_s",
                                  workloads=["moe8.long"]))
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data
    e2e = _run(root, "moe8.long", seconds=0.3)
    traced = _run(root, "moe8.long", trace=True, seconds=0.3)
    assert e2e["correct"] and traced["correct"]
    assert {"out_tok_s", "ttft_ms", "setup_s"} <= set(e2e["metrics"])
    done = traced["metrics"]["requests_done"]
    assert done["unit"] == "requests" and done["value"] == traced["attempted"]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_file_that_states_what_does_not_run_is_refused(tmp_path):
    root = smoke_root(tmp_path)
    path = root / "perfbench" / "configs" / "moe-smoke.json"
    conf = json.loads(path.read_text())
    conf["attention_bias"] = True   # the port's block runs no q/k/v bias
    path.write_text(json.dumps(conf))
    with pytest.raises(harness.RunError, match="attention_bias"):
        _run(root, "moe.smoke")


@pytest.mark.parametrize("mix", [
    dict(loop="open", clients=1, requests=[{"ii": 8, "oo": 4, "bb": 2}]),
    dict(loop="closed", clients=2, requests=[{"ii": 8, "oo": 4, "bb": 2}]),
    dict(loop="closed", clients=1, requests=[{"ii": 8, "oo": 4, "bb": 2},
                                             {"ii": 16, "oo": 3, "bb": 2}]),
])
def test_a_mix_the_engine_cannot_serve_is_refused(mix):
    with pytest.raises(ValueError):
        Mix(mix, 256, SEED)


def test_loaded_forbidden_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_like", types.ModuleType(
        "repro_torch_like"))
    assert "repro_torch_like" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "repro.core", types.ModuleType("x"))
    assert "repro.core" in harness.loaded_forbidden()


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "qwen2.5-32b.decode", "--seed", str(SEED), "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=env)


def test_the_command_refuses_a_checkout_without_the_program(tmp_path):
    shutil.copytree(REPO / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _command(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is here: the command would run the cell")


def test_the_command_refuses_to_run_without_a_card(no_card):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(REPO, env)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA device" in out.stderr
