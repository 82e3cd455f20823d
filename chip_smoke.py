#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths on one NVIDIA card: serving
llama3.1-8b, and the ALA pipeline (paper Alg 1-8) on the paper's data.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and, on a line of its own, its name and power
   limit as ``nvidia-smi`` prints them;
2. build: ``nvcc`` builds the CUDA kernels from ``src/repro_torch/csrc``
   (one process per source, all at once) with their register and spill
   counts; Triton compiles the RMSNorm kernel at its first launch;
3. each kernel against its plain PyTorch version on the card: the shape
   sweeps of ``tests/test_kernels.py``, ragged lengths, the llama3.1-8b
   widths and a cache holding NaN past the fill level, fp32 within 2e-5
   and bf16 within 2e-2; the GBT-histogram kernel at the ALA's shapes and
   8k x 8 within 1e-4, and bit for bit to its contract (float32
   ``np.add.at`` in row order, two launches, alone and in a batch,
   compacted and zero-weighted rows);
4. each kernel timed with CUDA events at the main path's shapes, beside its
   bound, its plain version and one PyTorch library call computing the
   same function;
5. llama3.1-8b at full width cut to 2 layers, on the card through the
   kernels against the CPU through the plain versions, same weights;
6. llama3.1-8b at full width (32 layers, bf16, seeded random weights)
   served by ``ServingEngine.measure_throughput``; the kernels' launch
   counters are zeroed before and must show the expected launches after;
7. one traced prefill and 8 decode steps per cell (torch.profiler): the
   device's busy share and the kernels that take its time;
8. serving rows as ALA input: ``measure_arch`` sweeps the full-width model
   over a small grid and the port's Alg 2 database is fitted on the rows;
9. ALA on the card on ``inhouse`` with the quickstart settings (serial SA,
   then 4 chains), its stage times beside the same flow on the CPU; the
   GBT-histogram launches must equal the tree levels grown; the card is
   held to the CPU run: medAPE, the CPU's SA subsets evaluated again, and
   Alg 7+8 trained on the CPU's SA log (tolerances in ``ALA_TOL``);
10. the kernel table as one JSON line, then ``{"ok": true, ...}`` last.

It needs a CUDA card and the repository around it, and exits non-zero
without them or when any phase fails.
"""
from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

import torch  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 on the
# CUDA cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6
ARCH = "llama3.1-8b"
CELLS = ((512, 64, 8), (128, 128, 32))  # (ii, oo, bb) served at full width
REPS = 2
FP32, BF16 = torch.float32, torch.bfloat16
TOL = {FP32: 2e-5, BF16: 2e-2}
# K4 (L problems, n rows, f features, nodes, bins) on the ALA's path: the
# Alg 3 predictor (3 outputs) and the 4-chain SA evaluator (3 x candidates)
# over 48 (ii, oo) groups of 7 features in 64 bins, one level per node
# count; Alg 7 over 32 or 125 logged subsets of 24 features in 4 bins; and
# the reference benchmark's 8,192 x 8 shape.
K4_MAIN = (3, 48, 7, 16, 64)
K4_BIG = (1, 8192, 8, 1, 64)
K4_SHAPES = (K4_MAIN, (3, 48, 7, 1, 64), (3, 48, 7, 4, 64), (12, 48, 7, 8, 64),
             (15, 48, 7, 16, 64), (1, 32, 24, 16, 4), (1, 125, 24, 8, 4),
             K4_BIG)
K4_TOL = 1e-4
# the quickstart's SA settings (examples/quickstart.py)
SA_ITERS, SA_CHAINS = 30, 4
SA_GBT = dict(n_estimators=40, learning_rate=0.2, max_depth=4)
# ALA on the card against the same flow on the CPU.  The card's histograms
# are fp32 (K4) where the CPU's are float64, and its LM solve takes CUDA's
# expf.  ``python -m repro_torch.bench.ala_tolerance`` measures the first
# change alone on the CPU (PERF.md has its numbers); the gates allow twice
# its evaluate_batch differences, and 1e-6 where it found 2e-8 or less.
# medAPE comes from the LM fits alone (every test (ii, oo) is a database
# hit); confidence is the reference's 1e-6 contract.
ALA_TOL = dict(medape=0.01, eval_median=1.0, eval_max=15.0, err=1e-6,
               conf=1e-6)
MEASURE_GRID = dict(grid_ii=(128, 512), grid_oo=(16, 32), grid_bb=(1, 4, 16),
                    reps=2)


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def _close(got, want, dtype) -> bool:
    tol = TOL[dtype]
    return bool(torch.isclose(got.float(), want.float(), rtol=tol,
                              atol=tol).all())


class Checks:
    """Collects kernel-against-plain comparisons of one kernel."""

    def __init__(self, name):
        self.name, self.n, self.failed, self.err = name, 0, [], {}

    def add(self, case, got, want, dtype):
        torch.cuda.synchronize()
        self.n += 1
        key = str(dtype).replace("torch.", "")
        self.err[key] = max(self.err.get(key, 0.0), _err(got, want))
        if not _close(got, want, dtype):
            self.failed.append(f"{case} {key} err {_err(got, want):.3g}")

    def report(self):
        errs = ", ".join(f"{k} max err {v:.3g}" for k, v in self.err.items())
        print(f"[3] {self.name}: {self.n} cases against the plain version, "
              f"{errs} (tolerance fp32 2e-5, bf16 2e-2): "
              f"{'FAIL ' + '; '.join(self.failed) if self.failed else 'ok'}")
        return not self.failed


def _ptxas_summary(log: str):
    """(kernel, registers, spill bytes) per entry function of a -v log."""
    rows, name, spill = [], None, 0
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"([a-z]+_fwd)I(13__nv_bfloat16|f)Li(\d+)E", line)
            dtype = "fp32" if m and m[2] == "f" else "bf16"
            name = (f"{m[1]}<{dtype}, {m[3]}>" if m else
                    "gbt_hist_kernel" if "gbt_hist_kernel" in line
                    else line.split("'")[1])
        elif "spill stores" in line:
            spill = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif "Used" in line and "registers" in line and name:
            regs = int(line.split("Used")[1].split("registers")[0])
            rows.append((name, regs, spill))
            name = None
    return rows


def time_ms(fn, arg_sets, iters=60):
    """Mean ms per call of ``fn(*args)`` with CUDA events after a warm-up
    pass, cycling through ``arg_sets`` so that inputs larger in all than the
    L2 arrive cold."""
    for args in arg_sets * 2:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _n_sets(nbytes):
    return max(2, math.ceil(3 * L2_BYTES / nbytes))


def _device_profile(fn):
    """Traces one call of ``fn`` with torch.profiler: wall ms, ms of device
    work, (kernel name, launches, ms) sorted by time, and the same for the
    host's operators by their own CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            n, us = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, us + e.device_time_total)
    busy = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(((k, n, us / 1e3) for k, (n, us) in by_name.items()),
                 key=lambda row: -row[2])
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in prof.key_averages()), key=lambda row: -row[2])
    return wall * 1e3, busy, top, host


def _bound(nbytes, ops, peak):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _hist_inputs(rng, L, n, f, n_nodes, n_bins, lo=0):
    """Seeded K4 inputs as numpy; ``lo < 0`` mixes in out-of-range ids."""
    return (rng.integers(lo, n_bins - lo, (L, n, f)).astype(np.int32),
            rng.standard_normal((L, n)).astype(np.float32),
            rng.random((L, n)).astype(np.float32),
            rng.integers(lo, n_nodes - lo, (L, n)).astype(np.int32))


def _add_at(bins, grad, hess, node, n_nodes, n_bins):
    """float32 np.add.at over the flat cell index, in row order: K4's
    contract, bit for bit."""
    L, n, f = bins.shape
    out = np.zeros((L, n_nodes, f, n_bins, 2), np.float32)
    ok = ((bins >= 0) & (bins < n_bins) & (node[..., None] >= 0)
          & (node[..., None] < n_nodes))
    li, ri, fi = np.nonzero(ok)
    for k, w in enumerate((grad, hess)):
        np.add.at(out, (li, node[li, ri], fi, bins[li, ri, fi], k), w[li, ri])
    return out


def k4_checks(rng):
    """K4 against its plain version at the ALA's shapes (atol K4_TOL) and
    its exact contract; returns (ok, max error, report lines)."""
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.gbt_hist.ref import gbt_hist_ref

    def on_card(arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).cuda()
                for a in arrays]

    def hist(arrays, nn, nb):
        return gh_ops.build_node_histograms(*on_card(arrays), nn, nb)

    failed, err = [], 0.0
    for L, n, f, nn, nb in K4_SHAPES:
        arrays = _hist_inputs(rng, L, n, f, nn, nb)
        got = hist(arrays, nn, nb)
        want = gbt_hist_ref(*on_card(arrays), nn, nb)
        torch.cuda.synchronize()
        e = _err(got, want)
        err = max(err, e)
        if not e <= K4_TOL:
            failed.append(f"{(L, n, f, nn, nb)} err {e:.3g}")
    # the contract: float32 np.add.at in row order, ids out of range
    # included; two launches; one problem alone and among L
    exact = []
    for L, n, f, nn, nb in K4_SHAPES:
        arrays = _hist_inputs(rng, L, n, f, nn, nb, lo=-1)
        first, second = hist(arrays, nn, nb), hist(arrays, nn, nb)
        alone = hist([a[L // 2:L // 2 + 1] for a in arrays], nn, nb)
        exact.append(np.array_equal(first.cpu().numpy(),
                                    _add_at(*arrays, nn, nb))
                     and torch.equal(first, second)
                     and torch.equal(first[L // 2:L // 2 + 1], alone))
    # compacted rows against the same rows kept with zero weight
    bins, grad, hess, node = _hist_inputs(rng, 1, 300, 7, 16, 64)
    keep = rng.random(300) < 0.6
    w = keep.astype(np.float32)
    zeroed = hist((bins, grad * w, hess * w, node), 16, 64)
    compact = hist([a[:, keep] for a in (bins, grad, hess, node)], 16, 64)
    exact.append(torch.equal(zeroed, compact))
    ok = not failed and all(exact)
    lines = [f"[3] gbt_hist: {len(K4_SHAPES)} shapes against the plain "
             f"version, max err {err:.3g} (tolerance {K4_TOL}); bit for bit "
             f"to float32 np.add.at, across two launches, alone and in a "
             f"batch, compacted and zero-weighted: {sum(exact)} of "
             f"{len(exact)}: {'ok' if ok else 'FAIL ' + '; '.join(failed)}"]
    return ok, err, lines


def k4_timing(rng, shape):
    """K4 at ``shape`` timed beside its plain version and one
    ``index_add_`` over the precomputed flat cell index; bound = its
    bytes (each input read once, the histograms written once) over the
    memory rate, or its fp32 adds over the fp32 peak."""
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.gbt_hist.ref import gbt_hist_ref
    L, n, f, nn, nb = shape
    size = L * nn * f * nb
    sets, lib_sets = [], []
    for _ in range(2):
        arrays = _hist_inputs(rng, L, n, f, nn, nb)
        sets.append(tuple(torch.from_numpy(a).cuda() for a in arrays))
        bins, grad, hess, node = sets[-1]
        flat = (((torch.arange(L, device="cuda")[:, None, None] * nn
                  + node[:, :, None].long()) * f
                 + torch.arange(f, device="cuda")) * nb + bins.long())
        src = torch.stack([grad, hess], -1)[:, :, None].expand(L, n, f, 2)
        lib_sets.append((flat.reshape(-1), src.reshape(-1, 2).contiguous()))
    nbytes = 4 * L * n * f + 3 * 4 * L * n + 2 * 4 * size
    got = gh_ops.build_node_histograms(*sets[0], nn, nb)
    want = gbt_hist_ref(*sets[0], nn, nb)
    return dict(
        name="gbt_hist", shape=f"L{L} n{n} f{f} nodes{nn} bins{nb}",
        check=(got, want),
        ms=time_ms(lambda *t: gh_ops.build_node_histograms(*t, nn, nb), sets),
        plain_ms=time_ms(lambda *t: gbt_hist_ref(*t, nn, nb), sets),
        library_ms=time_ms(lambda flat, src: torch.zeros(
            size, 2, device="cuda").index_add_(0, flat, src), lib_sets),
        bound=_bound(nbytes, 2 * L * n * f, PEAK_FP32))


def _trees(model):
    return [np.concatenate([getattr(t, k) for t in m.trees_])
            for m in getattr(model, "models", [model])
            for k in ("feature", "threshold", "left", "right", "value")]


def _same_trees(a, b) -> bool:
    return all(np.array_equal(x, y) for x, y in zip(_trees(a), _trees(b)))


def run_ala(device, train, test):
    """The quickstart flow on ``device``: fit, score, serial SA, Alg 7,
    estimate, estimate_batch; then SA over SA_CHAINS chains, Alg 7 and
    estimate_batch again.  Returns the ALA, its serial log, the numbers
    and the stage times."""
    from repro_torch.core.ala import ALA
    from repro_torch.core.annealing import SAConfig
    ala = ALA(device=device)
    ala.cfg.sa = SAConfig(n_iters=SA_ITERS, gbt_kw=dict(SA_GBT))
    times = {}
    ala.fit(*train)
    score = ala.score(*test)
    serial = ala.explore(test)
    ala.fit_error()
    err, conf = ala.estimate(test)
    b_err, _, b_conf = ala.estimate_batch([test])
    times.update(ala.timings)
    ala.explore(test, n_chains=SA_CHAINS)
    ala.fit_error()
    ala.estimate_batch([test])
    times.update({f"{k}_chains": ala.timings[k] for k in (
        "explore_s", "fit_error_s", "estimate_batch_s")})
    return ala, serial, dict(
        medape=score, serial_best=serial.best_error,
        chains_best=ala.sa_log.best_error, n_serial=len(serial.subsets),
        n_chains=len(ala.sa_log.subsets), err=err, conf=conf,
        batch_err=float(b_err[0]), batch_conf=float(b_conf[0])), times


def ala_phase(smi):
    """Phase 9: ALA on the card, the same flow on the CPU, and the card
    held to the CPU run.  Returns (ok, K4 launches on the ALA path)."""
    from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
    from repro_torch.core import database, fit, gbt
    from repro_torch.core.annealing import _BatchedEvaluator
    from repro_torch.core.error_predictor import (predict_error,
                                                  train_error_predictor)
    from repro_torch.core.predictor import train_param_predictor
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    train, test = (d.workload for d in
                   train_test_split(make_inhouse_dataset(), 0.3))
    gh_ops.build_node_histograms.launches = 0
    gbt._joint_histograms.levels = 0
    t0 = time.perf_counter()
    card, card_log, got, card_t = run_ala(None, train, test)
    card_wall = time.perf_counter() - t0
    launches = gh_ops.build_node_histograms.launches
    levels = gbt._joint_histograms.levels
    t0 = time.perf_counter()
    _, cpu_log, want, cpu_t = run_ala("cpu", train, test)
    cpu_wall = time.perf_counter() - t0
    ok = launches == levels > 0
    for name, walls, t in (("card", card_wall, card_t),
                           ("CPU", cpu_wall, cpu_t)):
        stages = ", ".join(f"{k} {v:.3f}" for k, v in t.items())
        print(f"[9] ALA on the {name}: {walls:.1f} s in all; {stages} "
              f"[{smi}]")
    for k in got:
        print(f"[9]   {k}: card {got[k]!r}, CPU {want[k]!r}")
    print(f"[9] gbt_hist launches {launches}, tree levels grown {levels}: "
          f"{'ok' if ok else 'FAIL'}")
    checks = {"held-out medAPE": abs(got["medape"] - want["medape"])
              <= ALA_TOL["medape"]}
    # the CPU run's serial-SA subsets evaluated again on the card
    ev = {dev: _BatchedEvaluator(train, test, dict(SA_GBT, **kw),
                                 device=dev).evaluate_batch(cpu_log.subsets)
          for dev, kw in (("cuda", {}), ("cpu", {}))}
    ev32 = _BatchedEvaluator(train, test, dict(SA_GBT, use_kernel=True),
                             device="cpu").evaluate_batch(cpu_log.subsets)
    d = np.abs(ev["cuda"] - ev["cpu"])
    d32 = np.abs(ev["cuda"] - ev32)
    print(f"[9] the CPU's {len(d)} SA subsets evaluated on the card: "
          f"|card - CPU float64| median {float(np.median(d))!r}, max "
          f"{float(d.max())!r} points (tolerance {ALA_TOL['eval_median']}, "
          f"{ALA_TOL['eval_max']}); |card - CPU fp32 plain K4| median "
          f"{float(np.median(d32))!r}, max {float(d32.max())!r}")
    checks["SA subsets re-evaluated"] = (
        np.median(d) <= ALA_TOL["eval_median"]
        and d.max() <= ALA_TOL["eval_max"])
    # Alg 7 + 8 on the card, trained on the CPU's SA log
    card.sa_log, card._bank = cpu_log, None
    card.fit_error()
    c_err, c_conf = card.estimate(test)
    b_err, _, b_conf = (float(v[0]) for v in card.estimate_batch([test]))
    sig = [card._signature(test)]
    plain = train_error_predictor(cpu_log, device="cpu", use_kernel=True)
    plain_err = float(predict_error(plain, sig, cpu_log.universes)[0])
    f64 = train_error_predictor(cpu_log, device="cpu")
    f64_err = float(predict_error(f64, sig, cpu_log.universes)[0])
    print(f"[9] Alg 7+8 on the card from the CPU's SA log: error {c_err!r} "
          f"(batch {b_err!r}), CPU float64 {f64_err!r}, CPU fp32 plain "
          f"K4 {plain_err!r}; confidence {c_conf!r} (batch {b_conf!r}), "
          f"CPU {want['conf']!r}")
    checks["Alg 7 error"] = (abs(c_err - f64_err) <= ALA_TOL["err"]
                             and c_err == plain_err)
    checks["Alg 7 trees = plain K4's"] = _same_trees(card.error_model, plain)
    checks["Alg 8 confidence"] = (
        abs(c_conf - want["conf"]) <= ALA_TOL["conf"]
        and abs(b_conf - want["conf"]) <= ALA_TOL["conf"])
    # Alg 3 on the card from the CPU's database rows: K4's trees
    db = database.build_exponential_database(*train, device="cpu")
    checks["Alg 3 trees = plain K4's"] = _same_trees(
        train_param_predictor(db.training, device="cuda"),
        train_param_predictor(db.training, device="cpu", use_kernel=True))
    # the device traversal, the LM's batch invariance, incremental Alg 2
    X = np.random.default_rng(0).uniform(0, 1, (64, 24))
    checks["forest traversal"] = np.array_equal(
        card.error_model.predict(X, backend="torch"),
        gbt.pack_models([[card.error_model]]).predict(
            X[None], backend="numpy")[0, :, 0])
    ii, oo, bb, thpt = train
    full = database.build_exponential_database(ii, oo, bb, thpt)
    keys, inv = np.unique(np.stack([ii, oo], 1), axis=0, return_inverse=True)
    groups = [(bb[inv == g], thpt[inv == g],
               full.params[tuple(keys[g])]) for g in (3, 17, 40)]
    pad = int(np.bincount(inv).max())
    checks["LM batch invariance"] = np.array_equal(
        fit.fit_exponential_groups(groups, pad_to=pad)[:1],
        fit.fit_exponential_groups(groups[:1], pad_to=pad))
    n_old = len(ii) - 500
    prev = database.build_exponential_database(
        ii[:n_old], oo[:n_old], bb[:n_old], thpt[:n_old])
    upd = database.update_exponential_database(prev, ii, oo, bb, thpt,
                                               n_delta=500)
    checks["incremental Alg 2"] = np.array_equal(upd.training, full.training)
    print(f"[9] checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                      for k, v in checks.items()))
    # where the card's ALA time goes: one SA evaluation of 4 candidates
    # and one Alg 7 fit, traced after a warm-up evaluation
    ev_card = _BatchedEvaluator(train, test, dict(SA_GBT), device="cuda")
    ev_card.evaluate_batch(cpu_log.subsets[:4])
    for what, fn in (
            ("evaluate_batch of 4 SA subsets",
             lambda: ev_card.evaluate_batch(cpu_log.subsets[4:8])),
            ("Alg 7 fit on the CPU's SA log",
             lambda: train_error_predictor(cpu_log, device="cuda"))):
        wall, busy, top, host = _device_profile(fn)
        kernels = "; ".join(f"{name[:40]} x{n} {ms:.3f} ms"
                            for name, n, ms in top[:5])
        ops = "; ".join(f"{name[:32]} x{n} {ms:.3f} ms"
                        for name, n, ms in host[:6])
        print(f"[9] traced {what}: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms ({100 * busy / wall:.1f}%); top kernels: "
              f"{kernels}; top host ops (self CPU): {ops} [{smi}]")
    return ok and all(checks.values()), launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.inference.engine import ServingEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.models.transformer import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # -- 1. device --------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1] device: {kind}, {torch.cuda.device_count()} visible, "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"[2] nvcc built {sorted(logs) or 'nothing (already built)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for src, log in logs.items():
        for fn, regs, spill in _ptxas_summary(log):
            print(f"[2]   {src}: {fn}: {regs} registers, {spill} B spilled")
    t0 = time.perf_counter()
    rms_ops.rmsnorm(torch.ones((1, 64), device="cuda"),
                    torch.ones(64, device="cuda"))
    torch.cuda.synchronize()
    print(f"[2] triton compiled rmsnorm in {time.perf_counter() - t0:.1f} s")

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator("cuda").manual_seed(0)
    rms_c = Checks("rmsnorm")
    for shape in ((8, 64), (3, 5, 128), (1, 256), (17, 96), (8, 4096),
                  (4096, 4096)):
        for dt in (FP32, BF16):
            x = _randn(gen, shape, dt)
            scale = _randn(gen, shape[-1:], FP32)
            rms_c.add(shape, rms_ops.rmsnorm(x, scale), rmsnorm_ref(x, scale),
                      dt)
    fa_c = Checks("flash_attention")
    for b, h, kv, s, dh in ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64),
                            (1, 4, 1, 128, 128), (2, 6, 2, 64, 32),
                            (1, 4, 2, 50, 16), (2, 32, 8, 512, 128),
                            (2, 32, 8, 1000, 128)):
        for causal in (True, False):
            for dt in (FP32, BF16):
                q = _randn(gen, (b, s, h, dh), dt)
                k = _randn(gen, (b, s, kv, dh), dt)
                v = _randn(gen, (b, s, kv, dh), dt)
                want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), causal=causal)
                fa_c.add((b, h, kv, s, dh, causal),
                         fa_ops.flash_attention(q, k, v, causal=causal),
                         want.transpose(1, 2), dt)
    da_c = Checks("decode_attention")
    decode_cases = [(2, 8, 2, 128, 64), (1, 4, 4, 512, 128),
                    (4, 16, 8, 256, 64), (3, 4, 2, 77, 16)]
    decode_cases += [(b, 32, 8, t, 128) for b in (1, 8, 64) for t in (576, 2080)]
    for b, h, kv, t, dh in decode_cases:
        for frac in (0.1, 0.5, 1.0):
            for dt in (FP32, BF16):
                q = _randn(gen, (b, h, dh), dt)
                k = _randn(gen, (b, t, kv, dh), dt)
                v = _randn(gen, (b, t, kv, dh), dt)
                pos = int((t - 1) * frac)
                want = decode_attention_ref(
                    q.reshape(b, kv, h // kv, dh), k.transpose(1, 2),
                    v.transpose(1, 2), pos).reshape(b, h, dh)
                da_c.add((b, h, kv, t, dh, pos),
                         da_ops.decode_attention(q, k, v, pos), want, dt)
    # stale cache: entries past pos, 99 / -99 as in test_kernels.py, or NaN
    q = _randn(gen, (1, 4, 32), FP32)
    k = _randn(gen, (1, 128, 2, 32), FP32)
    v = _randn(gen, (1, 128, 2, 32), FP32)
    clean = da_ops.decode_attention(q, k, v, 63)
    for fill_k, fill_v in ((99.0, -99.0), (math.nan, math.nan)):
        k2, v2 = k.clone(), v.clone()
        k2[:, 64:], v2[:, 64:] = fill_k, fill_v
        da_c.add(("stale", fill_k), da_ops.decode_attention(q, k2, v2, 63),
                 clean, FP32)
    ok3 = all([c.report() for c in (rms_c, fa_c, da_c)])
    rng = np.random.default_rng(0)
    ok_k4, k4_err, lines = k4_checks(rng)
    print("\n".join(lines))
    ok3 = ok3 and ok_k4

    # -- 4. timing at the main path's shapes --------------------------------
    cfg = get_config(ARCH)
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    table, timings = {}, []
    for ii, oo, bb in CELLS:
        # rmsnorm over the prefill's rows and one decode step's rows
        for rows in (bb * ii, bb):
            x = _randn(gen, (rows, d), BF16)
            scale = torch.ones(d, device="cuda")
            nbytes = 2 * rows * d * 2 + d * 4
            sets = [(_randn(gen, (rows, d), BF16), scale)
                    for _ in range(_n_sets(nbytes))]
            wscale = scale.to(BF16)
            timings.append(dict(
                name="rmsnorm", shape=f"{rows}x{d} bf16",
                check=(rms_ops.rmsnorm(x, scale), rmsnorm_ref(x, scale)),
                ms=time_ms(rms_ops.rmsnorm, sets),
                plain_ms=time_ms(rmsnorm_ref, sets),
                library_ms=time_ms(lambda t, _s: torch.nn.functional.rms_norm(
                    t, (d,), wscale, 1e-5), sets),
                bound=_bound(nbytes, 4 * rows * d, PEAK_FP32)))
        # flash attention over the prompt, causal
        shp_q, shp_kv = (bb, ii, h, dh), (bb, ii, kv, dh)
        nbytes = 2 * bb * ii * (2 * h + 2 * kv) * dh
        sets = [tuple(_randn(gen, sh, BF16) for sh in (shp_q, shp_kv, shp_kv))
                for _ in range(_n_sets(nbytes))]
        q, k, v = sets[0]

        def fa_plain(q, k, v):
            return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)

        def fa_lib(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)

        timings.append(dict(
            name="flash_attention", shape=f"B{bb} S{ii} H{h} KV{kv} Dh{dh} bf16",
            check=(fa_ops.flash_attention(q, k, v),
                   fa_plain(q, k, v).transpose(1, 2)),
            ms=time_ms(fa_ops.flash_attention, sets),
            plain_ms=time_ms(fa_plain, sets), library_ms=time_ms(fa_lib, sets),
            bound=_bound(nbytes, 4 * bb * h * dh * ii * (ii + 1) // 2,
                         PEAK_BF16)))
        # decode attention at the last step: the cache holds ii + oo - 1
        t, pos = ii + oo, ii + oo - 1
        nbytes = 2 * bb * h * dh * 2 + 2 * bb * (pos + 1) * kv * dh * 2
        sets = [(_randn(gen, (bb, h, dh), BF16),
                 _randn(gen, (bb, t, kv, dh), BF16),
                 _randn(gen, (bb, t, kv, dh), BF16))
                for _ in range(_n_sets(nbytes))]
        q, k, v = sets[0]

        def da(q, k, v):
            return da_ops.decode_attention(q, k, v, pos)

        def da_plain(q, k, v):
            return decode_attention_ref(
                q.reshape(bb, kv, h // kv, dh), k.transpose(1, 2),
                v.transpose(1, 2), pos).reshape(bb, h, dh)

        def da_lib(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q[:, :, None], k[:, :pos + 1].transpose(1, 2),
                v[:, :pos + 1].transpose(1, 2), enable_gqa=True)

        timings.append(dict(
            name="decode_attention",
            shape=f"B{bb} T{t} pos{pos} H{h} KV{kv} Dh{dh} bf16",
            check=(da(q, k, v), da_plain(q, k, v)),
            ms=time_ms(da, sets), plain_ms=time_ms(da_plain, sets),
            library_ms=time_ms(da_lib, sets),
            bound=_bound(nbytes, 4 * bb * h * dh * (pos + 1), PEAK_BF16)))
        del sets, q, k, v
    timings += [k4_timing(rng, K4_MAIN), k4_timing(rng, K4_BIG)]
    ok4 = True
    for tm in timings:
        got, want = tm.pop("check")
        tm["err"] = _err(got, want)
        ok4 = ok4 and (tm["err"] <= K4_TOL if tm["name"] == "gbt_hist"
                       else _close(got, want, BF16))
        bound_ms, bound_by = tm["bound"]
        print(f"[4] {tm['name']} {tm['shape']}: kernel {tm['ms']:.4f} ms, "
              f"bound {bound_ms:.3g} ms ({bound_by}), plain "
              f"{tm['plain_ms']:.4f} ms, library {tm['library_ms']:.4f} ms, "
              f"max err {tm['err']:.3g} [{smi}]")
        # the JSON line reports each kernel at the first cell's prefill
        # shape, and gbt_hist at the ALA predictor's first shape
        table.setdefault(tm["name"], tm)
    table["gbt_hist"]["err"] = max(table["gbt_hist"]["err"], k4_err)
    torch.cuda.empty_cache()

    # -- 5. 2-layer llama width, card against CPU -------------------------
    t0 = time.perf_counter()
    cfg2 = cfg.scaled(n_layers=2)
    card = Model(cfg2).init(torch.Generator("cuda").manual_seed(0))
    cpu = Model(cfg2).load({n: p.cpu() for n, p in card.named_parameters()})
    cpu_gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=cpu_gen)
    steps = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=cpu_gen)
    got, gcache = card.prefill(toks.cuda(), 68)
    want, ccache = cpu.prefill(toks, 68)
    errs, ok5 = [_err(got.cpu(), want)], _close(got.cpu(), want, BF16)
    for tok in steps:
        got, gcache = card.decode_step(gcache, tok.cuda())
        want, ccache = cpu.decode_step(ccache, tok)
        errs.append(_err(got.cpu(), want))
        ok5 = ok5 and _close(got.cpu(), want, BF16)
    ok5 = ok5 and bool(torch.isfinite(got).all())
    print(f"[5] 2-layer llama3.1-8b width, card vs CPU: last-token logits "
          f"max err prefill {errs[0]:.3g}, decode "
          f"{', '.join(f'{e:.3g}' for e in errs[1:])} (bf16 tol 2e-2): "
          f"{'ok' if ok5 else 'FAIL'} ({time.perf_counter() - t0:.1f} s)")
    del card, cpu, gcache, ccache
    torch.cuda.empty_cache()

    # -- 6. full width ------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[6] {ARCH}: {n_params / 1e9:.3f} B parameters, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"init {time.perf_counter() - t0:.1f} s")
    probe = torch.randint(0, cfg.vocab_size, (2, 16), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(2))
    logits, _ = model.prefill(probe)
    ok6 = (tuple(logits.shape) == (2, 1, cfg.padded_vocab)
           and bool(torch.isfinite(logits).all()))
    engine = ServingEngine(model)
    counters = (rms_ops.rmsnorm, fa_ops.flash_attention,
                da_ops.decode_attention)
    for fn in counters:
        fn.launches = 0
    n_layers = cfg.n_layers
    for ii, oo, bb in CELLS:
        before = [fn.launches for fn in counters]
        rows = engine.measure_throughput(ii, oo, bb, reps=REPS)
        grew = [fn.launches - b for fn, b in zip(counters, before)]
        n_gen = 1 + REPS  # one warm-up generate, then the measured ones
        expect = [(2 * n_layers + 1) * n_gen * oo, n_layers * n_gen,
                  n_layers * n_gen * (oo - 1)]
        ok6 = ok6 and grew == expect and all(
            r["thpt"] > 0 and r["prefill_s"] > 0 and r["decode_s"] > 0
            for r in rows)
        for r in rows:
            print(f"[6] ii={ii} oo={oo} bb={bb}: thpt {r['thpt']:.1f} tok/s, "
                  f"prefill {r['prefill_s']:.4f} s, decode "
                  f"{r['decode_s']:.4f} s, peak memory "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                  f"[{smi}]")
        print(f"[6] launches rmsnorm/flash/decode: {grew}, expected {expect}")
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[6] main path launches: {launches}: {'ok' if ok6 else 'FAIL'}")

    # -- 7. where the time goes: one traced prefill and 8 decode steps per
    # cell (the tracer adds host time, so busy shares read low) -----------
    for ii, oo, bb in CELLS:
        prompts = torch.randint(0, cfg.vocab_size, (bb, ii), device="cuda",
                                generator=torch.Generator("cuda").manual_seed(3))
        _, cache = model.prefill(prompts, ii + oo)

        def decode8(cache=cache, tok=prompts[:, -1:]):
            for _ in range(8):
                _, cache = model.decode_step(cache, tok)

        for what, fn in ((f"prefill B{bb} S{ii}",
                          lambda: model.prefill(prompts, ii + oo)),
                         (f"8 decode steps B{bb} from pos {ii}", decode8)):
            wall, busy, top, host = _device_profile(fn)
            kernels = "; ".join(f"{name[:48]} x{n} {ms:.3f} ms"
                                for name, n, ms in top[:6])
            ops = "; ".join(f"{name[:40]} x{n} {ms:.3f} ms"
                            for name, n, ms in host[:6])
            print(f"[7] {what}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
                  f"({100 * busy / wall:.1f}%); top kernels: {kernels}; "
                  f"top host ops (self CPU): {ops} [{smi}]")

    # -- 8. serving rows as ALA input --------------------------------------
    from repro_torch.bench.harness import measure_arch
    from repro_torch.core.annealing import median_ape
    from repro_torch.core.database import build_exponential_database, db_predict
    t0 = time.perf_counter()
    rows = measure_arch(ARCH, model=model, **MEASURE_GRID)
    ii, oo, bb, thpt = rows.workload
    db = build_exponential_database(ii, oo, bb, thpt)
    pred = np.concatenate([db_predict(db, a, o, bb[(ii == a) & (oo == o)])
                           for a, o in db.params])
    own = np.concatenate([thpt[(ii == a) & (oo == o)] for a, o in db.params])
    ok8 = (len(rows) == 24 and bool(np.all(thpt > 0))
           and set(rows["acc"]) == {"gpu-h100-sxm"} and len(db) == 4
           and bool(np.all(np.isfinite(db.training))))
    print(f"[8] measure_arch {ARCH}: {len(rows)} rows (acc "
          f"{', '.join(sorted(set(rows['acc'])))}, back "
          f"{', '.join(sorted(set(rows['back'])))}, prec "
          f"{', '.join(sorted(set(rows['prec'])))}) in "
          f"{time.perf_counter() - t0:.1f} s [{smi}]")
    for (a, o), th in db.params.items():
        print(f"[8]   (ii, oo) = ({a:g}, {o:g}): theta (a, b, c) = "
              f"({float(th[0])!r}, {float(th[1])!r}, {float(th[2])!r}); "
              f"thpt at bb 1/4/16: "
              f"{', '.join(f'{t:.1f}' for t in thpt[(ii == a) & (oo == o)])}")
    print(f"[8] Alg 2 fit medAPE on its own rows: "
          f"{median_ape(own, pred)!r}%: {'ok' if ok8 else 'FAIL'}")
    del model, engine
    torch.cuda.empty_cache()

    # -- 9. ALA on the card against the CPU ---------------------------------
    t0 = time.perf_counter()
    ok9, k4_launches = ala_phase(smi)
    launches["gbt_hist"] = k4_launches
    print(f"[9] ALA phase: {'ok' if ok9 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 10. result -----------------------------------------------------------
    sources = {"rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                           "src/repro/kernels/rmsnorm/kernel.py:24"),
               "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:76"),
               "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:67"),
               "gbt_hist": ("cuda", "src/repro_torch/csrc/gbt_hist.cu",
                            "src/repro/kernels/gbt_hist/kernel.py:49")}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        tm = table[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=tm["err"], ms=tm["ms"],
            plain_ms=tm["plain_ms"], bound_ms=tm["bound"][0],
            bound_by=tm["bound"][1], library_ms=tm["library_ms"],
            shape=tm["shape"]))
    ok = (ok3 and ok4 and ok5 and ok6 and ok8 and ok9
          and all(k["launches"] > 0 for k in kernels))
    print(f"[10] phases: kernels {ok3}, timing shapes {ok4}, 2-layer {ok5}, "
          f"full width {ok6}, measure_arch {ok8}, ALA {ok9}; "
          f"{time.perf_counter() - t_start:.0f} s in all")
    if not ok:
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
