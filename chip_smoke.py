#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

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
   and bf16 within 2e-2;
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
8. the kernel table as one JSON line, then ``{"ok": true, ...}`` last.

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
            name = f"{m[1]}<{dtype}, {m[3]}>" if m else line.split("'")[1]
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
    ok4 = True
    for tm in timings:
        got, want = tm.pop("check")
        tm["err"] = _err(got, want)
        ok4 = ok4 and _close(got, want, BF16)
        bound_ms, bound_by = tm["bound"]
        print(f"[4] {tm['name']} {tm['shape']}: kernel {tm['ms']:.4f} ms, "
              f"bound {bound_ms:.3g} ms ({bound_by}), plain "
              f"{tm['plain_ms']:.4f} ms, library {tm['library_ms']:.4f} ms, "
              f"max err {tm['err']:.3g} [{smi}]")
        # the JSON line reports each kernel at the first cell's prefill shape
        table.setdefault(tm["name"], tm)
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

    # -- 8. result ------------------------------------------------------------
    sources = {"rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                           "src/repro/kernels/rmsnorm/kernel.py:24"),
               "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:76"),
               "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:67")}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        tm = table[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches[name], max_abs_err=tm["err"], ms=tm["ms"],
            plain_ms=tm["plain_ms"], bound_ms=tm["bound"][0],
            bound_by=tm["bound"][1], library_ms=tm["library_ms"],
            shape=tm["shape"]))
    ok = ok3 and ok4 and ok5 and ok6 and all(k["launches"] > 0
                                             for k in kernels)
    print(f"[8] phases: kernels {ok3}, timing shapes {ok4}, 2-layer {ok5}, "
          f"full width {ok6}; {time.perf_counter() - t_start:.0f} s in all")
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
