#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card: serving
the five dense configs (llama3.1-8b, llama3.2-3b, qwen3-0.6b, qwen2.5-32b,
command-r-35b), the MoE and recurrent ones (phi3.5-moe,
llama4-maverick, xlstm-125m, jamba), whisper-medium's encoder-decoder
path and internvl2-1b's vision stub, the ALA pipeline (paper Alg 1-8)
on the paper's data and on the rows the card measures, the serving
stack with ALA in the loop (the roofline simulator, the fleet and heap
engines, the autoscaler and the online refit), its observability
layer (spans, the calibration audit, the Chrome trace), and training
(qwen3-0.6b whole through ``Trainer.run``, with the backward kernels of
RMSNorm and flash attention), the sharding policy on one rank, and its
dry run at production scale (256 fake ranks, the kernels as shape-only
ops) held to the real calls.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. device: the card's name and, on a line of its own, its name and power
   limit as ``nvidia-smi`` prints them;
2. build: ``nvcc`` builds the CUDA kernels from ``src/repro_torch/csrc``
   (one process per source, all at once: RMSNorm, flash attention, decode
   attention, the GBT kernels) with their register and spill counts (and
   decode attention's shared memory a block); the tensor-core gate:
   ``cuobjdump -sass`` of the built flash-attention library must show HMMA
   or HGMMA instructions in every bf16 instantiation of the kernel, and
   that of its backward HGMMA (``wgmma``) instructions in every bf16
   instantiation of its dK/dV and dQ kernels, whose ptxas reports must
   show no byte spilled;
3. each kernel against its plain PyTorch version on the card: the shape
   sweeps of ``tests/test_kernels.py``, ragged lengths, the configs'
   widths (RMSNorm at d 128 over qwen3's q/k-norm rows, 1,024 to 8,192,
   xlstm-125m's 768 and the smoke models' 64;
   both attentions at 16, 24, 32, 40 and 64 query heads over 8) and a
   cache holding NaN past the fill level, fp32 within 2e-5 and bf16 within
   2e-2; RMSNorm plain and fused with the residual add, whose sum must be
   ``x + r`` bit for bit; decode attention captured in a CUDA graph and
   replayed with the position changed in device memory, at positions that
   cross split boundaries (at 32 and 24 query heads), bit-equal at each to
   the eager call; flash attention also at ragged S around its
   64-row tiles for every head size, and on strided views whose
   surroundings hold NaN; decode attention where several splits run (B 1
   and 8 at a 2,080-slot cache, pos at 0, around a split boundary and at
   T - 1) also within 1e-6 (fp32) or one bf16 ulp of its split arithmetic
   emulated in torch and bit-equal across two calls (B 8 cut into 2 and 5
   splits, which its own plan does not do), with NaN past pos in bf16 and
   on NaN-bordered strided views; K4's histogram kernel at the ALA's shapes
   and 8k x 8 within 1e-4, and bit for bit to its contract (float32
   ``np.add.at`` in row order, two launches, alone and in a batch,
   compacted and zero-weighted rows); K4's split step bit for bit to its
   plain version on the card in every tensor it writes, at the ALA's
   levels and 8k rows, every kind of ``cases.level_case`` (ties, blocked
   splits, an empty problem, wide-exponent histograms), searching and
   last levels; K4's whole-fit kernel (``gbt_grow``, one launch a fit)
   bit for bit in every tensor of the state to its plain version on the
   host at the main path's fits (Alg 3, the registry's, Alg 7, the two
   baseline GBTs, every tree), the cluster the library plans for each and
   its shared memory as ``ops.grow_smem_bytes`` counts it; the level path,
   which no main-path fit takes: the vanilla XGBoost baseline on
   ``suite``'s 11,088 rows, a fit beyond one block's shared memory, grown
   level by level (``gbt_hist`` and ``gbt_split`` a level) with trees equal
   to the host loop's, its launches kept out of the main path's counts;
4. each kernel timed with CUDA events at the main path's shapes, beside its
   bound, its plain version and one PyTorch library call computing the
   same function (none for the split step; for the fused RMSNorm the two
   calls ``x + r`` and ``F.rms_norm``), and for RMSNorm the device time of
   a ``copy_`` that moves the same bytes; then the kernel's device ms
   per call (every kernel of the call summed) and the library call's, from
   one torch.profiler pass each; RMSNorm also at a prefill's rows of every
   newer width (d 64 and 768 included) and of qwen3's q/k norms, with
   how it cuts each width; for decode attention also its n_split, grid
   and achieved GB/s, its device ms with the positions cut into 1, 2, 4
   and 8 splits, and the same at
   the newer configs' groups (2, 3, 5, 8 query heads a KV head); K4 also
   at the registry's 114 problems; ``gbt_grow`` a whole fit at each main
   path fit's shape, its plain version once, its bound from the
   candidates those trees searched (its result held to phase [3]'s plain
   trees);
5. each of the five configs at full width cut to 2 layers, on the card
   through the kernels against the CPU through the plain versions, same
   weights; then its decode step replayed as a CUDA graph
   (``DecodeGraph``) against 16 eager greedy steps, logits and tokens bit
   for bit, and the captured step's RMSNorm and decode-attention nodes
   counted from the graph (one a norm, QK-norms included; one a layer);
6. llama3.1-8b at full width (32 layers, bf16, seeded random weights)
   served by ``ServingEngine.measure_throughput``, which replays a CUDA
   graph a decode step; the kernels' launch counters and the engine's
   captures and replays are zeroed before and must show the expected
   counts after (kernels count at capture and at the eager warm-up step
   before it, not at replays); then, at the same cells, the eager loop of
   ``decode_step`` calls, with its tokens equal to the engine's; the
   compile gates: ``measure_throughput`` builds nothing (its one capture
   is held by the counts above), the ``generate`` after it compiles
   nothing;
7. one traced prefill, 8 eager decode steps and 8 graph replays per cell
   (torch.profiler): the device's busy share, the kernels that take its
   time and the port's own kernels' share; the captured step must hold 65
   RMSNorm and 32 decode-attention kernel nodes, listed from the graph
   through the CUDA driver, and a trace of 8 more replays must show both
   kernels by name, never more of them than 8 steps hold;
8. serving rows as ALA input: ``measure_arch`` sweeps the full-width model
   over a small grid (through the graphed engine) and the port's Alg 2
   database is fitted on the rows;
9. ALA on the card on ``inhouse`` with the quickstart settings (serial SA,
   then 4 chains), its stage times beside the same flow on the CPU and
   their ratios; every fit grown on the card (``grow_forests``) one
   ``gbt_grow`` launch, with no launch a level and no level by the host
   loop; the card is held to the CPU run: medAPE, the CPU's SA subsets
   evaluated again, and Alg 7+8 trained on the CPU's SA log (tolerances in
   ``ALA_TOL``), Alg 3's and Alg 7's trees equal to the host loop's over
   K4's plain histograms; a traced SA evaluation and Alg 7 fit with their
   device-to-host copies and synchronisations, the fit held to exactly one
   ``gbt_grow`` launch for its 1,000 levels and at most 10 copies back;
10. llama3.2-3b, qwen3-0.6b, qwen2.5-32b and command-r-35b at full width
    and full depth (seeded random weights, nothing cut), one after
    another, each through ``measure_arch`` over phase [8]'s grid with its
    launches counted exactly; parameters, peak memory, seconds and
    throughput per model, and 8 replays of its graphed step traced (device
    ms a step by kernel kind: K1, K3, GEMM, sort, gather/scatter, other);
11. Alg 4: ``ModelRegistry`` fitted on the card on ``suite`` plus the five
    models' card rows, in one batched fit (one LM solve a padding class,
    one ``grow_forests``, one ``gbt_grow`` launch, for every combination's
    Alg 3), against the same
    fit on the CPU: databases within the LM contract (``core.fit.lm_agreement``; the
    same comparison must refuse the card's LM run in bf16 or cut to 20
    steps), Alg 3's trees equal to the host loop's over K4's plain
    histograms, medAPE within
    ``ALA_TOL``; then ``fit_uncertainty`` on the five card combinations
    (the default ``SAConfig``), their estimates, and transfer to an A100
    and a TPU v4 (donors the card's combinations, confidence below native
    at every row) and to unregistered hardware (the sentinel);
12. ``OnlineALA`` on the card ingests the five models' rows in two deltas,
    its predictions after each bit-equal to a fresh card registry's, each
    fit one ``gbt_grow`` launch; its gate quarantines an injected NaN row
    and an exact duplicate;
13. the Fig 7 baselines on ``inhouse`` on the card and the CPU: held-out
    medAPE beside phase [9]'s ALA, within ``ALA_TOL``; the tree baselines'
    trees equal to the host loop's over K4's plain histograms, each GBT
    one ``gbt_grow`` launch, the random forest (it samples columns) K4's
    histograms a level;
14. the MoE and recurrent blocks: (a) phi3.5-moe and llama4-maverick at
    full width cut to 2 layers (llama4's one period), xlstm-125m whole
    and jamba at its smoke size, each as phase [5] checks a model (card
    against CPU, 16 graph replays bit-equal to eager steps, recurrent
    states included, K1/K3 graph nodes), one eager decode step under
    ``torch.cuda.set_sync_debug_mode("error")``; (b) jamba's blocks at
    full width one at a time: its Mamba mixer (d 8,192, d_inner 16,384)
    on the card against the CPU over a 64-token prefill and 4 decode
    steps, its MoE FFN (16 experts of d_ff 24,576) on the card against a
    plain per-expert loop over 4,096 tokens, with a seeded and a zeroed
    router (which overflows capacity: the same entries dropped, their
    tokens' output exactly zero); (c) phi3.5-moe at 24 of 32 layers,
    llama4-maverick at one period and xlstm-125m whole through
    ``measure_arch`` as phase [10] runs it, launches counted exactly
    (its rows are printed, not fed to phase [11]);
15. whisper-medium (24 encoder and 24 decoder layers over 1,500 stub
    frames, cross attention) and internvl2-1b (24 layers, 256 stub
    patches before the prompt): (a) the kernels at their new shapes
    against their plain versions: K2 with a key length of its own (Sq 1,
    16, 128, 512 against Sk 63, 64, 65, 1,500, causal and full), at S =
    Sk = 1,500 (the encoder, a ragged tail) and on strided views with NaN
    around them, at G 1 (16/16 heads) and G 7 (14/2); K3 over a
    1,500-slot cache at pos 0, 700 and 1,499 (cross attention in a decode
    step) from a device tensor; K1 at d 896; (b) timed beside their
    bounds, plain versions and SDPA: K2 at the encoder's (B 16, S 1,500,
    full), the cross prefill's (B 16, Sq 512, Sk 1,500) and internvl2's
    prefill (B 16, S 768, G 7), K3 at cross decode (B 16, T 1,500) and
    the two models' self decode (G 1, G 7), K1 at d 896; (c) both models
    at full width cut to 2 layers (whisper 2 encoder and 2 decoder
    layers, all 1,500 frames) card against CPU in bf16, 16 graph replays
    bit-equal to eager steps (cross K/V included), the captured step's
    K1/K3 nodes, an eager step under ``set_sync_debug_mode("error")``;
    (d) both whole through ``measure_arch`` as phase [10] runs a model,
    exact launches, a graphed step beside its bound (rows printed, not
    fed to phase [11]);
16. the serving stack, which runs no model: (a) the three datasets
    (``inhouse``, ``suite``, ``mismatch``) made anew by the roofline
    simulator, bit for bit ``results/data/*.npz``; (b)
    ``benchmarks/run.py``'s ``fleet_engine`` scenario at its full size
    (three tenants, diurnal load and flash crowds, 2,000 s, about 110,644
    requests; llama3.1-8b on the simulator's TPU v5e profile at TP 4, 8
    replicas) through the vectorized fleet engine, its decode
    trajectories in numpy and then in float64 on the card
    (``traj_backend="torch"``): accounting, events, end time and every
    request's times equal; (c) the heap engine on the trace's first 60 s
    against the fleet engine by the reference's parity rule; (d)
    ``online_engine``'s closed loop at its full size: two models, 8
    epochs of 20 s, each simulated with an ``ALAAutoscaler`` attached to
    the ``OnlineALA`` on the card, its windows adapted and ingested (each
    refit one ``gbt_grow`` launch a fit), the predictions then within
    1e-6 of a from-scratch registry fit on the card; (e) printed, not a
    gate: the simulator's H100 profile beside phase [8]'s measured rows;
    gates: (b)'s runs compile nothing, (d)'s epochs stay within the first
    one's compile count + 2, and ``nan_guard`` passes (d)'s predictions;
17. the observability layer, ``benchmarks/run.py``'s ``obs_engine`` at
    its full size (three tenants over 600 s, 33,277 requests, the
    deployment of (16) (b)): (a) the fleet engine untraced and traced at
    sample rate 1 (the minimum of 3 runs each, in turns), the traced run
    equal to the untraced one plus its spans, and the time that deriving
    the spans adds under 5% of the untraced run's, with a
    span for every request; (b) the traced run with its trajectories on
    the card, its ``SpanTable`` equal to numpy's in every column, and a
    run capped at 20,000 step records on both backends with equal
    dropped counts, step arrays and totals; (c) heap against fleet spans
    over the first 60 s (exact counts, TTFT and E2E percentiles within
    the bucket's tolerance); (d) per-tenant TTFT shards merged within a
    bin of the exact p95, and the queue-depth series; (e) the Chrome
    trace written to ``chiprun_out/``; (f) the miscalibrated-prior online
    loop, one ``CalibrationAudit`` fed by the ``OnlineALA`` on the card
    and by the ``ALAAutoscaler``: at least 5 ticks, a refit event, a
    monotone reliability curve, each refit's fits one ``gbt_grow``
    launch, its summary beside the reference's CPU record and its events
    written to ``chiprun_out/``;
18. training: (a) K1's backward (plain and fused) at qwen3-0.6b's
    hidden norms (16,384 x 1,024) and q/k norms (262,144 x 128), and
    K2's backward (dQ, dK, dV) at its training shape (B 4, S 4,096, 16/8
    heads, causal), whisper's encoder (S 1,500, full) and cross
    attention (Sq 512, Sk 1,500), fp32 and bf16, against their plain
    versions, bit-equal over two runs, the forward's LSE against the
    plain one, K2's bf16 backward within one bf16 ulp of its emulated
    rounding points (``attention_bwd_bf16_emulated``, on the card in
    fp32) but for 0.1% of the elements, which stay within 8; both timed
    beside their bounds, plain versions and the library's backward
    (``F.rms_norm``'s and SDPA's, by autograd); (b)
    one ``Trainer`` step of qwen3-0.6b at 2 layers, full width, S 512,
    card against CPU from the same parameters (fp32: loss 1e-4, each
    gradient and updated parameter 1e-3 and 1e-4 of its norm; bf16: the
    loss 2e-2); (c) qwen3-0.6b whole (28 layers) through ``Trainer.run``
    at S 4,096, B 4, 10 steps: losses and grad norms finite, the last
    below the first, exact launches a step (28 K2 forwards and
    backwards, 113 K1 norms and their backwards), the final checkpoint's
    seconds, step ms, tokens/s, TFLOP/s, peak memory, and one traced
    step's device ms by kind (GEMM, K2 forward and backward, K1 forward
    and backward, the cross entropy and the optimizer by their profiler
    ranges, other); (d) the reference's restart drill at (b)'s cut;
19. the sharding policy (``distributed/``, ``launch/``) on a one-rank
    NCCL group (a ``FileStore`` in a temporary directory, no TCP port)
    and the (1, 1) ("data", "model") mesh: (a) llama3.1-8b whole in bf16,
    a prefill (B 8, S 512) through ``build_prefill_step`` and 8 eager
    decode steps through ``build_serve_step`` (serving, 2D weights), the
    logits bit for bit equal to the policy-free ``Model.prefill`` /
    ``decode_step``, K1-K3 launching exactly as often, every parameter a
    DTensor at ``tree_shardings``' placements; (b) qwen3-0.6b whole
    through ``Trainer.run`` (S 4,096, B 4, 3 steps, no checkpoint) under
    a ZeRO-1 policy and without one, from the same seed: losses and
    parameters bit for bit, launches equal; the policy and policy-free
    ms of the prefill, a decode step and a training step, and peak
    memory, printed (records, not gates); one more policy prefill and
    training step each counted under ``launch/cost.py::StepCost`` (its
    FLOPs and the call's peak memory, for [21]); the group destroyed;
21. (run before [20]) the dry run (``launch/dryrun.py``, ``analysis/``)
    in a subprocess (``chip_smoke.py --dryrun-phase OUT``: one process
    cannot hold phase [19]'s NCCL group and a 256-rank fake group) that
    sees no card and runs beside phases [3] on, started after [2]'s
    build; [21] reads its results: (a) ``perf_report``'s three cells
    (qwen2.5-32b decode_32k, llama3.2-3b prefill_32k, llama4-maverick
    train_4k) traced as rank 0 of a 256-rank fake group on the (16, 16)
    mesh over meta tensors, full, u1 and u2, auto and baseline policy, on
    this machine's torch: every record ok, the ``report()`` table
    printed, the records copied to ``chiprun_out/dryrun/``; (b) phase
    [19]'s prefill and training step traced on a fake world of one rank:
    the traced FLOPs equal to those counted over the real call, the traced
    peak (arguments plus temp) within 10% of the real call's (its
    arguments plus what it allocated beyond what was live before it), the
    measured ms at least the compute term (FLOPs over 989 TFLOP/s), the
    memory term printed; (c) the K1-K3 launch counters, and the
    ``kernels`` line's counts, unchanged by the phase;
22. (run before [21]) the port's checker (``repro_torch.staticcheck``) on
    this machine's Python and torch over ``src/repro_torch``, this script
    and ``tests/test_torch_*.py``: 0 findings, and a planted seedless
    ``torch.randn`` caught as exactly one ``unseeded-rng`` finding;
20. the kernel table as one JSON line (``main_path`` false for
    ``gbt_split``, which only the level path launches: it must show no
    launch on the main path), then ``{"ok": true, ...}`` last.

It needs a CUDA card and the repository around it, and exits non-zero
without them or when any phase fails.
"""
from __future__ import annotations

import dataclasses
import gc
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

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 and
# fp64 on the CUDA cores, HBM3 bandwidth.
PEAK_BF16 = 989e12
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_BYTES = 3.35e12
L2_BYTES = 50e6
ARCH = "llama3.1-8b"
CELLS = ((512, 64, 8), (128, 128, 32))  # (ii, oo, bb) served at full width
REPS = 2
FP32, BF16 = torch.float32, torch.bfloat16
TOL = {FP32: 2e-5, BF16: 2e-2}
# a whole model's logits, card against CPU, bf16 as the kernels; fp32 at
# 1e-3: xlstm-125m's 12 recurrent layers carry another summation order to
# 1.0e-4 (H100 80GB HBM3, 700 W), while computing it in bf16 moves its
# logits by 0.23, so a bf16 rounding anywhere still fails by 200x
MODEL_TOL = {FP32: 1e-3, BF16: 2e-2}
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
# K4's split step timed at the Alg 3 fit's widest searching level: 8 nodes
# of 3 problems, 48 rows x 7 features x 64 bins (depth 3 of 4)
K4_SPLIT = (3, 48, 7, 8, 64)
# the split step's checks: (L, n, f, nodes, bins) of Alg 3's and Alg 7's
# levels and the 8,192-row problem, every kind of ``cases.level_case``
K4_SPLIT_CHECKS = ((3, 48, 7, 8, 64), (15, 48, 7, 16, 64), (1, 125, 24, 8, 4),
                   (1, 32, 24, 16, 4), (1, 8192, 8, 1, 64))
GROW_STATE = ("pred", "grad", "node", "level", "feature", "threshold",
              "left", "right", "value", "n_nodes")
# K4's whole fits on the main path are ``cases.MAIN_FITS``; phase [3]
# keeps each one's plain trees here for phase [4]
GROW_PLAIN = {}
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
# the four newer dense configs: phase [5] at 2 layers, phase [10] at full
# depth through measure_arch; with llama3.1-8b, five combinations of rows
# the card measures for Alg 4 (phases [11], [12])
DENSE_NEW = ("llama3.2-3b", "qwen3-0.6b", "qwen2.5-32b", "command-r-35b")
GROUPS_NEW = (2, 3, 5, 8)        # their query heads a KV head (KV 8)
WIDTHS_NEW = (1024, 3072, 5120, 8192)   # their d_model
# phase [14]: the MoE and recurrent configs.  (a) card against CPU:
# phi3.5-moe and llama4-maverick at full width cut to 2 layers (llama4's
# one period of a dense and a MoE block), xlstm-125m whole, and jamba at
# its smoke size (None: whole); (b) jamba's Mamba mixer and MoE FFN at
# full width, one block each, the FFN over MOE_TOKENS tokens; (c)
# measure_arch at full width: phi3.5-moe at 24 of its 32 layers (the 32
# take 83.7 GB), llama4-maverick one period (2 of 48), xlstm-125m whole
# xlstm-125m and jamba's smoke model are held in fp32 (MODEL_TOL), bf16
# printed beside it: bf16
# rounding alone moves their logits by 0.15 to 1.0 on one CPU (sLSTM's
# exp input gates; the smoke model's 4 experts, where a rounding flips a
# token's route), so no two bf16 runs of them agree within 2e-2
BLOCK_CHECKS = (("phi3.5-moe-42b-a6.6b", 2, BF16),
                ("llama4-maverick-400b-a17b", 2, BF16),
                ("xlstm-125m", None, FP32))
BLOCK_MEASURE = (("phi3.5-moe-42b-a6.6b", 24),
                 ("llama4-maverick-400b-a17b", 2), ("xlstm-125m", None))
JAMBA = "jamba-1.5-large-398b"
MOE_TOKENS = 4096
WIDTHS_BLOCKS = (768, 64)   # K1 at xlstm-125m's d_model, the smoke models'
# K1 over qwen3's q/k norms in a prefill of 8 x 1,024 tokens, 16 heads
QK_ROWS = (8192 * 16, 128)
# K4 at the registry's joint Alg 3 fit: 33 suite and 5 card combinations
# x 3 outputs, 16 database rows x 7 features, 16 nodes, 64 bins
K4_REG = (114, 16, 7, 16, 64)
# the online phase's SA budgets (the default SAConfig's 150 iterations cut
# for time)
ONLINE_SA = dict(n_iters=10, warm_iters=5)
# phase [15]: whisper-medium and internvl2-1b, at 2 layers (card against
# CPU) and whole (measure_arch); their (H, KV): G 1 and G 7, Dh 64.  Both
# are held in fp32 (MODEL_TOL), bf16 printed beside it: bf16 rounding
# alone moves their 2-layer logits by 0.021 to 0.026 on one CPU, more
# than bf16's 2e-2
ENCDEC = (("whisper-medium", dict(n_layers=2, n_encoder_layers=2)),
          ("internvl2-1b", dict(n_layers=2)))
ENCDEC_HEADS = ((16, 16), (14, 2))
# K2 with a key length of its own: query rows against key rows (whisper's
# 1,500 frames, and around one 64-key tile)
CROSS_SQ = (1, 16, 128, 512)
CROSS_SK = (63, 64, 65, 1500)
WIDTH_VLM = 896   # K1 at internvl2's d_model
# phase [16], the serving stack.  (b) benchmarks/run.py's fleet_engine
# scenario at its full size: three tenants over 2,000 s (seed 42),
# llama3.1-8b on the simulator's TPU v5e profile at TP 4 (the reference's
# simulated deployment: data, not a speed claim), 8 replicas, batch cap
# 64, 0.5 s buckets
FLEET = dict(horizon_s=2000.0, seed=42, batch_cap=64, n_replicas=8,
             bucket_s=0.5)
# (c) the heap engine on the trace's first 60 s, held to the fleet engine
# by the reference's parity rule (tests/test_fleet_parity.py::
# _assert_close): |TTFT| and |E2E| differences at p95 within its 0.35 s
# (written for 0.1 s buckets, so widened by this scenario's 0.5 s), at
# most 6 s, at most 5% beyond the p95 bound; TPOT's p95 within 0.05 s
HEAP_SLICE_S = 60.0
PARITY = dict(p95_s=0.35 + FLEET["bucket_s"], outlier_s=6.0,
              outlier_frac=0.05, tpot_s=0.05)
# (d) benchmarks/run.py's online_engine at its full size: two models, 8
# epochs of 20 s, its calibration grid, SA 20 iterations x 2 chains,
# warm_iters 6; its predictions held to a from-scratch registry fit
# within its 1e-6
ONLINE_LOOP = dict(archs=("llama3.1-8b", "qwen2.5-32b"), n_epochs=8,
                   epoch_s=20.0, parity=1e-6)
# phase [17], the observability layer: benchmarks/run.py's obs_engine at
# its full size.  (a) to (e): its three-tenant fleet trace over 600 s
# (seed 42; phase [16] (b)'s tenants and deployment), the tracing
# overhead gated on the minimum of 3 runs each way, a run capped at
# max_steps step records, heap against fleet over the first 60 s, and the
# Chrome trace's event caps; (f) at least min_ticks audited ticks
OBS = dict(horizon_s=600.0, seed=42, runs=3, overhead=0.05, parity_s=60.0,
           max_steps=20000, max_step_events=20000, max_span_events=5000,
           min_ticks=5)
# (f) the miscalibrated-prior online loop: 6 epochs of 20 s, its seed grid
# at 0.6 of the simulator's throughput
OBS_CAL = dict(n_epochs=6, epoch_s=20.0, derate=0.6)
# the reference's CPU run of obs_engine (results/BENCH_obs.json), printed
# beside the card's readings; of these only the seeded trace's request
# and event counts are gates
OBS_REF = dict(n_requests=33277, n_events=587307, trace_events=35025,
               calibration=dict(n_ticks=114, refit=7, events=152,
                                accuracy_rate=0.518,
                                ape_over_pred_err=1.019, bins=2))


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

    def add_norm(self, case, got, want, dtype):
        """A reduction's result, held by the norm of its error over the
        norm of ``want`` (an element that cancels to near zero carries
        the summation order's error)."""
        torch.cuda.synchronize()
        self.n += 1
        key = str(dtype).replace("torch.", "") + " (norm)"
        rel = ((got.float() - want.float()).norm()
               / want.float().norm().clamp_min(1e-30)).item()
        self.err[key] = max(self.err.get(key, 0.0), rel)
        if rel > TOL[dtype]:
            self.failed.append(f"{case} {key} err {rel:.3g}")

    def report(self, tag="[3]"):
        errs = ", ".join(f"{k} max err {v:.3g}" for k, v in self.err.items())
        print(f"{tag} {self.name}: {self.n} cases against the plain version, "
              f"{errs} (tolerance fp32 2e-5, bf16 2e-2): "
              f"{'FAIL ' + '; '.join(self.failed) if self.failed else 'ok'}")
        return not self.failed


def _kernel_name(symbol: str) -> str:
    """A readable name for a mangled entry function of csrc/*.cu."""
    m = re.search(r"([a-z][a-z_]*(?:_bf16|_fp32)?)I"
                  r"((?:13__nv_bfloat16|f|S\d*_)*)((?:L[ib]\d+E)+)", symbol)
    if not m:
        return next((k for k in ("gbt_hist_kernel", "gbt_split_kernel",
                                 "gbt_grow_kernel") if k in symbol), symbol)
    types = []
    for t in re.findall(r"13__nv_bfloat16|f|S\d*_", m[2]):
        # S<n>_ repeats an earlier type: here always the one before
        types.append(types[-1] if t.startswith("S") else
                     {"f": "fp32", "13__nv_bfloat16": "bf16"}[t])
    ints = re.findall(r"L[ib](\d+)E", m[3])
    return f"{m[1]}<{', '.join(types + ints)}>"


def time_ms(fn, arg_sets, iters=60):
    """Mean ms per call of ``fn(*args)`` with CUDA events after a warm-up
    pass, cycling through ``arg_sets`` so that inputs larger in all than the
    L2 arrive cold.  Each call's output is held until its set comes round
    again, so outputs rotate through as many buffers as the inputs: an
    output the allocator handed back at once would lie in the same L2
    lines each call, its writes never reaching the memory."""
    n = len(arg_sets)
    outs = [None] * n
    for i, args in enumerate(arg_sets * 2):
        outs[i % n] = fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        outs[i % n] = fn(*arg_sets[i % n])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, kernel=None, calls=20, passes=6):
    """Device ms per launch of the CUDA kernels whose names hold ``kernel``
    ("" matches every kernel); with a tuple of names, the sum of each
    name's device ms a launch, the device ms of a call that launches each
    of them once; with ``kernel=None``, device ms of all the work of one
    call.  Read from a torch.profiler pass over ``calls`` calls of ``fn``
    after a warm-up, outputs held as ``time_ms`` holds them.  The tracer
    runs the ``calls`` once as its own warm-up and keeps the second round:
    a trace that starts with the calls can lose the first kernels'
    records.  A trace can also lose records late in a long process (K2's
    backward once kept one call of 8, once none in six passes), which a
    mean a launch reads right and a sum a call does not: so a kernel that
    launches several kernels a call is read by their names.  A pass that
    holds no record of a name is made again, up to ``passes`` in all,
    every other one tracing the host too.  If none holds one, the calls
    are timed by CUDA events instead, which counts every kernel of a call
    and the gaps between them, and a line says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    names = kernel if isinstance(kernel, tuple) else (kernel,)
    n = len(arg_sets)
    outs = [fn(*args) for args in arg_sets]
    torch.cuda.synchronize()
    for attempt in range(passes):
        activities = [ProfilerActivity.CUDA] + \
            [ProfilerActivity.CPU] * (attempt % 2)
        kept = []
        with profile(activities=activities,
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: kept.append(list(p.events()))
                     ) as prof:
            for _ in range(2):
                for i in range(calls):
                    outs[i % n] = fn(*arg_sets[i % n])
                torch.cuda.synchronize()
                prof.step()
        # a scheduled trace marks its step on the device timeline too;
        # that span is no device work
        device = [e for e in (kept[-1] if kept else [])
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("ProfilerStep")]
        found = [[e.device_time_total for e in device
                  if name is None or name in e.name] for name in names]
        if all(found):
            if kernel is None:
                return sum(found[0]) / 1e3 / calls
            return sum(sum(us) / len(us) for us in found) / 1e3
    ms = time_ms(fn, arg_sets, iters=calls)
    print(f"[tracer] {passes} traces show no device work of "
          f"{kernel or 'the call'}; its device ms ({ms:.4f}) is read by CUDA "
          f"events over {calls} calls instead, every kernel of a call and "
          f"the gaps between them counted")
    return ms


def _copy_device_ms(nbytes, n_sets):
    """Device ms of one ``copy_`` that reads and writes ``nbytes`` in all,
    on ``n_sets`` buffers in turn: what the card's memory gives a kernel
    that only moves those bytes (a yardstick for bytes-bound kernels).
    A call is one kernel, so it is read a launch (``kernel=""`` matches
    every kernel): a trace that lost records does not lower it."""
    n = nbytes // 4  # bf16 elements read (and as many written)
    sets = [(torch.empty(n, dtype=BF16, device="cuda"),
             torch.ones(n, dtype=BF16, device="cuda")) for _ in range(n_sets)]
    return device_ms(lambda dst, src: dst.copy_(src), sets, kernel="")


def _n_sets(nbytes):
    return max(2, math.ceil(3 * L2_BYTES / nbytes))


def _device_profile(fn, warm=False):
    """Traces one call of ``fn`` with torch.profiler: wall ms, ms of device
    work, (kernel name, launches, ms) sorted by time, the same for the
    host's operators by their own CPU time, and counts of device-to-host
    copies and of stream and device synchronisations (the tracer's own
    closing one included).  With ``warm`` the tracer runs one call as its
    warm-up and keeps the second: a trace that starts with the call can
    lose its first kernels' records (seen in phases [7] and [9]).  A trace
    with no device event is taken again, up to three in all;
    ``counts["calls"]`` says how many calls of ``fn`` ran."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    steps = 2 if warm else 1
    for attempt in range(1, 4):   # again if the tracer saw no device work
        torch.cuda.synchronize()
        kept = []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=steps - 1, active=1)
                     if warm else None,
                     on_trace_ready=(lambda p: kept.append(
                         (list(p.events()), p.key_averages())))
                     if warm else None) as prof:
            for _ in range(steps):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                if warm:
                    prof.step()
        # the tracer clears a scheduled cycle's events once it is handed on
        events, averages = kept[-1] if warm else (prof.events(),
                                                  prof.key_averages())
        by_name = {}
        for e in events:
            # a scheduled trace marks its step on the device timeline too;
            # that span is no device work
            if (e.device_type == DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")):
                n, us = by_name.get(e.name, (0, 0.0))
                by_name[e.name] = (n + 1, us + e.device_time_total)
        if by_name:
            break
    busy = sum(us for _, us in by_name.values()) / 1e3
    top = sorted(((k, n, us / 1e3) for k, (n, us) in by_name.items()),
                 key=lambda row: -row[2])
    host = sorted(((e.key, e.count, e.self_cpu_time_total / 1e3)
                   for e in averages if not e.key.startswith("ProfilerStep")),
                  key=lambda row: -row[2])
    by_key = {e.key: e.count for e in averages}
    counts = dict(calls=attempt * steps,
                  dtoh=sum(n for k, (n, _) in by_name.items() if "DtoH" in k),
                  stream_syncs=by_key.get("cudaStreamSynchronize", 0),
                  device_syncs=by_key.get("cudaDeviceSynchronize", 0))
    return wall * 1e3, busy, top, host, counts


def _kernel_launches(fn, keys):
    """For each of ``keys``: the device kernels whose names hold it, in a
    trace of ``fn()`` by torch.profiler with device activity alone.  The
    tracer runs one call of ``fn`` as its warm-up first and keeps the
    second: a trace that starts with the call loses the first few kernels'
    records (seen in phase [7] of this script)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    names = []

    def keep(prof):
        names.extend(e.name for e in prof.events()
                     if e.device_type == DeviceType.CUDA)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], on_trace_ready=keep,
                 schedule=schedule(wait=0, warmup=1, active=1)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return [sum(k in n for n in names) for k in keys]


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

    def kernel(*t):
        return gh_ops.build_node_histograms(*t, nn, nb)

    def library(flat, src):
        return torch.zeros(size, 2, device="cuda").index_add_(0, flat, src)

    return dict(
        name="gbt_hist", shape=f"L{L} n{n} f{f} nodes{nn} bins{nb}",
        check=(got, want), ms=time_ms(kernel, sets),
        plain_ms=time_ms(lambda *t: gbt_hist_ref(*t, nn, nb), sets),
        library_ms=time_ms(library, lib_sets),
        device_ms=device_ms(kernel, sets, "gbt_hist_kernel"),
        library_device_ms=device_ms(library, lib_sets),
        bound=_bound(nbytes, 2 * L * n * f, PEAK_FP32))


def _bits(t):
    """``t``'s bits as integers: equal exactly when the values are the same
    bit for bit (-0.0 and 0.0 differ, as NaNs of one payload agree)."""
    return t.contiguous().view({1: torch.uint8, 2: torch.int16,
                                4: torch.int32, 8: torch.int64}[
                                    t.element_size()])


def split_checks():
    """K4's split step against its plain version on the card, bit for bit
    in every tensor of the state: each ``K4_SPLIT_CHECKS`` shape, every
    kind of level (wide-exponent histograms included), at a searching level
    and at a tree's last.  Returns (ok, report line)."""
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.gbt_hist.cases import (KINDS, level_case,
                                                    level_state)
    from repro_torch.kernels.gbt_hist.ref import gbt_split_ref
    same, splits = [], 0
    for L, n, f, width, nb in K4_SPLIT_CHECKS:
        depth = width.bit_length() - 1
        for kind in KINDS:
            c = level_case(len(same), L, width, f, nb, kind, n=n)
            hist = torch.from_numpy(c["hist"]).cuda()
            for max_depth in (depth + 1, depth):
                card, plain = (level_state(c, 2, max_depth, "cuda")
                               for _ in range(2))
                gh_ops.split_level(hist, card, 1, depth, max_depth, 1.0,
                                   c["mcw"], 0.1)
                gbt_split_ref(hist, plain, 1, depth, max_depth, 1.0,
                              c["mcw"], 0.1)
                same.append(all(torch.equal(_bits(getattr(card, k)),
                                            _bits(getattr(plain, k)))
                                for k in GROW_STATE))
                splits += int((card.feature >= 0).sum())
    ok = all(same)
    return ok, (f"[3] gbt_split: {len(same)} levels ({len(K4_SPLIT_CHECKS)} "
                f"shapes x {len(KINDS)} kinds, searching and last; {splits} "
                f"splits) bit for bit to the plain version on the card: "
                f"{sum(same)} of {len(same)}: {'ok' if ok else 'FAIL'}")


def split_timing():
    """K4's split step at ``K4_SPLIT``, timed beside its plain version, each
    call on the same level: the rows, predictions and level it moves are
    restored before every call, outside the CUDA events around it.  Bound:
    the histograms read once, each valid node's tree entries (5 x 4 B) and
    each row's next node (4 B) written, over the memory rate; or its fp64
    operations (13 a candidate split) over the fp64 peak.  No PyTorch call
    computes the step: no library time."""
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.gbt_hist.cases import level_case, level_state
    from repro_torch.kernels.gbt_hist.ref import gbt_split_ref
    L, n, f, width, nb = K4_SPLIT
    depth = width.bit_length() - 1
    c = level_case(0, L, width, f, nb, n=n)
    c["n_valid"][:] = width
    hist = torch.from_numpy(c["hist"]).cuda()
    start = level_state(c, 1, depth + 1, "cuda")
    moved = ("pred", "node", "level")

    def run(fn, s, iters=60):
        pairs = []
        for i in range(iters + 5):
            for k in moved:
                getattr(s, k).copy_(getattr(start, k))
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(hist, s, 0, depth, depth + 1, 1.0, 1.0, 0.1)
            ev[1].record()
            pairs += [ev] if i >= 5 else []
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    card, plain = (level_state(c, 1, depth + 1, "cuda") for _ in range(2))
    gh_ops.split_level(hist, card, 0, depth, depth + 1, 1.0, 1.0, 0.1)
    gbt_split_ref(hist, plain, 0, depth, depth + 1, 1.0, 1.0, 0.1)
    got = torch.cat([getattr(card, k).double().reshape(-1) for k in GROW_STATE])
    want = torch.cat([getattr(plain, k).double().reshape(-1)
                      for k in GROW_STATE])
    nbytes = hist.numel() * 4 + L * width * 20 + L * n * 4
    s = level_state(c, 1, depth + 1, "cuda")

    def kernel():
        for k in moved:
            getattr(s, k).copy_(getattr(start, k))
        gh_ops.split_level(hist, s, 0, depth, depth + 1, 1.0, 1.0, 0.1)

    return dict(
        name="gbt_split", shape=f"L{L} n{n} f{f} nodes{width} bins{nb}",
        check=(got, want), ms=run(gh_ops.split_level, s),
        plain_ms=run(gbt_split_ref, level_state(c, 1, depth + 1, "cuda")),
        library_ms=None, device_ms=device_ms(kernel, [()], "gbt_split_kernel"),
        library_device_ms=None,
        bound=_bound(nbytes, 13 * L * width * f * nb, PEAK_FP64))


def _grow_case(name):
    """``cases.MAIN_FITS[name]``'s seeded inputs: (case, L, n, f, bins,
    depth, trees)."""
    from repro_torch.kernels.gbt_hist.cases import MAIN_FITS, fit_case
    L, n, f, nb, d, T, distinct = MAIN_FITS[name]
    c = fit_case(len(name), L, n, f, nb, distinct=distinct)
    return c, L, n, f, nb, d, T


def grow_checks():
    """gbt_grow against its plain version, bit for bit in every tensor of
    the state, at each ``cases.MAIN_FITS`` shape, every tree: one launch on
    the card, ``gbt_grow_ref`` on the host, whose fp32 histograms add in
    row order as the kernel's do (``index_add_`` on the card adds in no
    fixed order); the plain states go to ``GROW_PLAIN``.  Also the
    cluster the library plans for the fit on this card, and its shared
    memory against ``ops.grow_smem_bytes``.  Returns (ok, report lines)."""
    from repro_torch.kernels.gbt_hist import kernel, ops as gh_ops
    from repro_torch.kernels.gbt_hist.cases import MAIN_FITS, fit_state
    lines, ok = [], True
    for name in MAIN_FITS:
        c, L, n, f, nb, d, T = _grow_case(name)
        card, plain = fit_state(c, T, d, "cuda"), fit_state(c, T, d, "cpu")
        t0 = time.perf_counter()
        gh_ops.grow_fit(card, T, d, nb, 1.0, 1.0, 0.1)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        gh_ops.grow_fit(plain, T, d, nb, 1.0, 1.0, 0.1)
        t2 = time.perf_counter()
        GROW_PLAIN[name] = plain
        same = [k for k in GROW_STATE if torch.equal(
            _bits(getattr(card, k)).cpu(), _bits(getattr(plain, k)))]
        most, smem = kernel.grow_plan(L, n, f, nb, d)
        mirror = gh_ops.grow_smem_bytes(n, f, nb, d, most)
        good = len(same) == len(GROW_STATE) and smem == mirror
        ok = ok and good
        per, blocks = gh_ops.grow_split(f, most)
        lines.append(
            f"[3] gbt_grow {name} (L {L}, n {n}, f {f}, {nb} bins, depth {d}, "
            f"{T} trees): one launch, {int((card.feature >= 0).sum())} "
            f"splits, {len(same)} of {len(GROW_STATE)} state tensors bit for "
            f"bit to gbt_grow_ref on the host ({1e3 * (t1 - t0):.1f} ms on the "
            f"card with its build, {t2 - t1:.1f} s on the host); the plan: "
            f"clusters of {blocks} blocks x {per} features, {smem} B of "
            f"shared memory a block (ops.grow_smem_bytes {mirror}): "
            f"{'ok' if good else 'FAIL'}")
    return ok, lines


def level_path_check(smi):
    """The level path, which no main-path fit takes: the vanilla XGBoost
    baseline fitted on ``suite``'s 11,088 rows, beyond one block's shared
    memory, on the card (``gbt_hist`` and ``gbt_split`` a level) and by the
    host loop over K4's plain histograms; trees equal, two launches a
    level and no ``gbt_grow``.  Its launches are counted here only.
    Returns (ok, report line)."""
    from repro_torch.bench.datasets import load_or_make
    from repro_torch.core.baselines import _stack, make_baselines
    card, cpu = (make_baselines(dev)["vanilla_xgboost"].factory()
                 for dev in (None, "cpu"))
    cpu.use_kernel = True
    suite = load_or_make("suite")
    X = _stack(suite["ii"], suite["oo"], suite["bb"])
    y = np.asarray(suite["thpt"], np.float64)
    _zero_k4()
    t0 = time.perf_counter()
    card.fit(X, y)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    k4 = _read_k4()
    _zero_k4()
    t0 = time.perf_counter()
    cpu.fit(X, y)
    cpu_s = time.perf_counter() - t0
    levels = card.n_estimators * (card.max_depth + 1)
    same = _same_trees(card, cpu)
    ok = (same and k4["gbt_hist"] == k4["gbt_split"] == k4["levels"] == levels
          and k4["gbt_grow"] == 0 and k4["fits"] == 1)
    return ok, (
        f"[3] level path: vanilla_xgboost on suite's {len(y)} rows, beyond a "
        f"block's shared memory: fit card {card_s:.3f} s, CPU host loop over "
        f"K4's plain histograms {cpu_s:.3f} s; K4 launches gbt_hist "
        f"{k4['gbt_hist']}, gbt_split {k4['gbt_split']}, gbt_grow "
        f"{k4['gbt_grow']} ({levels} levels, not counted as the main "
        f"path's); trees equal: {same}: {'ok' if ok else 'FAIL'} [{smi}]")


def _searched_nodes(feature, left, right, n_nodes, max_depth):
    """Nodes above the last level in grown trees (L, T, N): each took a
    split search over every feature's bins."""
    L, T, N = feature.shape
    depth = np.zeros((L, T, N), np.int64)
    li, ti = np.meshgrid(np.arange(L), np.arange(T), indexing="ij")
    for i in range(N):   # a child's id is above its parent's
        split = feature[:, :, i] >= 0
        for child in (left, right):
            c = np.where(split, child[:, :, i], 0)
            depth[li[split], ti[split], c[split]] = depth[:, :, i][split] + 1
    used = np.arange(N) < n_nodes[..., None]
    return int((used & (depth < max_depth)).sum())


def grow_timing(name):
    """gbt_grow, one whole fit at ``cases.MAIN_FITS[name]``, timed with CUDA
    events over 10 fits, each on a fresh copy of the starting state (the
    copy outside the events), its device ms from the profiler, and the
    plain version (``gbt_grow_ref``, two launches a level and more) timed
    once on the card.  Bound: each input byte read once (bins, y, w, pred,
    grad, hess, node, level), each tree byte and the rows' final state
    written once, over the memory rate; or the split search's fp64
    operations (13 a candidate) over the fp64 peak, counting the candidates
    these trees searched (every node above the last level, every feature
    and bin).  No PyTorch call grows a fit: no library time.  The last
    timed fit is held to phase [3]'s plain state (``GROW_PLAIN``)."""
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    from repro_torch.kernels.gbt_hist.cases import fit_state
    from repro_torch.kernels.gbt_hist.ref import gbt_grow_ref
    c, L, n, f, nb, d, T = _grow_case(name)
    start = fit_state(c, T, d, "cuda")
    work = fit_state(c, T, d, "cuda")

    def fresh():
        for k in start.__dataclass_fields__:
            getattr(work, k).copy_(getattr(start, k))
        return work

    def run(fn, iters, warm):
        pairs = []
        for i in range(iters + warm):
            s = fresh()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(s, T, d, nb, 1.0, 1.0, 0.1)
            ev[1].record()
            pairs += [ev] if i >= warm else []
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters

    ms = run(gh_ops.grow_fit, 10, 2)
    got = torch.cat([getattr(work, k).double().reshape(-1).cpu()
                     for k in GROW_STATE])
    plain_s = GROW_PLAIN[name]
    want = torch.cat([getattr(plain_s, k).double().reshape(-1)
                      for k in GROW_STATE])
    plain_ms = run(gbt_grow_ref, 1, 0)   # seconds a fit: once
    device = device_ms(lambda: gh_ops.grow_fit(fresh(), T, d, nb, 1.0, 1.0,
                                               0.1), [()], "gbt_grow_kernel",
                       calls=5)
    N = 2 ** (d + 1) - 1
    nbytes = (L * n * (4 * f + 3 * 8 + 3 * 4) + 8 * L
              + L * T * (5 * 4 * N + 4) + L * n * (8 + 4 + 4))
    searched = _searched_nodes(*(getattr(plain_s, k).numpy() for k in (
        "feature", "left", "right", "n_nodes")), d)
    return dict(
        name="gbt_grow", shape=f"{name}: L{L} n{n} f{f} bins{nb} depth{d} "
        f"trees{T}", check=(got, want), ms=ms, plain_ms=plain_ms,
        library_ms=None, device_ms=device, library_device_ms=None,
        bound=_bound(nbytes, 13 * searched * f * nb, PEAK_FP64),
        searched=searched)


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
    held to the CPU run.  Returns (ok, {kernel: launches on the ALA path})
    for K4's kernels."""
    from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
    from repro_torch.core import database, fit, gbt
    from repro_torch.core.annealing import _BatchedEvaluator
    from repro_torch.core.error_predictor import (predict_error,
                                                  train_error_predictor)
    from repro_torch.core.predictor import train_param_predictor
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    train, test = (d.workload for d in
                   train_test_split(make_inhouse_dataset(), 0.3))
    counters = (gh_ops.build_node_histograms, gh_ops.split_level,
                gh_ops.grow_fit)
    _zero_k4()
    t0 = time.perf_counter()
    card, card_log, got, card_t = run_ala(None, train, test)
    card_wall = time.perf_counter() - t0
    k4 = _read_k4()
    launches = {k: k4[k] for k in ("gbt_hist", "gbt_split", "gbt_grow")}
    t0 = time.perf_counter()
    _, cpu_log, want, cpu_t = run_ala("cpu", train, test)
    cpu_wall = time.perf_counter() - t0
    # every fit on the card: one gbt_grow launch, no launch a level; no
    # level by the host loop
    ok = (k4["gbt_grow"] == k4["fits"] > 0 and k4["gbt_hist"] == 0
          and k4["gbt_split"] == 0 and k4["host_levels"] == 0)
    for name, walls, t in (("card", card_wall, card_t),
                           ("CPU", cpu_wall, cpu_t)):
        stages = ", ".join(f"{k} {v:.3f}" for k, v in t.items())
        print(f"[9] ALA on the {name}: {walls:.1f} s in all; {stages} "
              f"[{smi}]")
    print("[9] card / CPU: " + ", ".join(
        f"{k} {card_t[k] / cpu_t[k]:.2f}x" for k in card_t if cpu_t.get(k)))
    for k in got:
        print(f"[9]   {k}: card {got[k]!r}, CPU {want[k]!r}")
    print(f"[9] fits on the card {k4['fits']} ({k4['levels']} tree "
          f"levels): launches gbt_grow {k4['gbt_grow']}, gbt_hist "
          f"{k4['gbt_hist']}, gbt_split {k4['gbt_split']}; levels by the "
          f"host loop {k4['host_levels']}: {'ok' if ok else 'FAIL'}")
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
    # and one Alg 7 fit, traced after a warm-up evaluation.  Alg 7 grows
    # 200 trees of depth 4 (1,000 levels) in one gbt_grow launch, with no
    # launch a level and at most 10 copies back to the host in all
    ev_card = _BatchedEvaluator(train, test, dict(SA_GBT), device="cuda")
    ev_card.evaluate_batch(cpu_log.subsets[:4])
    for what, fn in (
            ("evaluate_batch of 4 SA subsets",
             lambda: ev_card.evaluate_batch(cpu_log.subsets[4:8])),
            ("Alg 7 fit on the CPU's SA log",
             lambda: train_error_predictor(cpu_log, device="cuda"))):
        before = [c.launches for c in counters]
        wall, busy, top, host, counts = _device_profile(fn, warm=True)
        grew = [(c.launches - b) / counts["calls"]
                for c, b in zip(counters, before)]
        kernels = "; ".join(f"{name[:40]} x{n} {ms:.3f} ms"
                            for name, n, ms in top[:6])
        ops = "; ".join(f"{name[:32]} x{n} {ms:.3f} ms"
                        for name, n, ms in host[:8])
        k4 = {k: sum(n for name, n, _ in top if k in name)
              for k in ("gbt_hist_kernel", "gbt_split_kernel",
                        "gbt_grow_kernel")}
        print(f"[9] traced {what}: wall {wall:.2f} ms, device busy "
              f"{busy:.2f} ms ({100 * busy / wall:.1f}%); K4 launches a call "
              f"gbt_hist {grew[0]:g}, gbt_split {grew[1]:g}, gbt_grow "
              f"{grew[2]:g} (in the trace {k4}); "
              f"{counts['dtoh']} device-to-host copies, "
              f"{counts['stream_syncs']} cudaStreamSynchronize, "
              f"{counts['device_syncs']} cudaDeviceSynchronize; top kernels: "
              f"{kernels}; top host ops (self CPU): {ops} [{smi}]")
        if what.startswith("Alg 7"):
            checks["traced Alg 7 fit: one gbt_grow launch, none a level, "
                   "<= 10 copies back"] = (
                grew == [0, 0, 1] and k4["gbt_grow_kernel"] == 1
                and counts["dtoh"] <= 10)
    print(f"[9] checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                      for k, v in checks.items()))
    return ok and all(checks.values()), launches, got["medape"]


def _flash_want(q, k, v, causal):
    """K2's plain version on (B, S, H, Dh) tensors."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal).transpose(1, 2)


def _decode_want(q, k, v, pos):
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    b, h, dh = q.shape
    kv = k.shape[2]
    return decode_attention_ref(q.reshape(b, kv, h // kv, dh),
                                k.transpose(1, 2), v.transpose(1, 2),
                                pos).reshape(b, h, dh)


def _split_positions(t, n_split):
    """pos at 0; nearest t / 2, where the last split ends full (a split
    boundary - 1), holds one row (on it) and two rows (+ 1); at t - 1."""
    from repro_torch.kernels.decode_attention.kernel import splits_of

    def last_rows(p):
        return (p + 1) % splits_of(p, n_split)[1]
    return (0, *(min((p for p in range(t) if last_rows(p) == r),
                     key=lambda p: abs(p - t // 2)) for r in (0, 1, 2)),
            t - 1)


def _decode_split(q, k, v, pos, n_split):
    """K3 with its positions cut into at most n_split splits (a grid of
    n_split capped at the cache's tiles); pos an int or a device tensor."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    out = torch.empty_like(q)
    if not isinstance(pos, torch.Tensor):
        pos = torch.tensor([pos], device=q.device)
    da_kernel.decode_attention_bhd(
        q, k, v, out, pos, min(n_split, -(-k.shape[1] // da_kernel.TILE)),
        q.shape[-1] ** -0.5)
    return out


def decode_graph_checks(gen):
    """K3 captured once in a CUDA graph and replayed with the position
    changed in device memory, at positions that cross split boundaries
    (B 1 with the wrapper's own plan, up to 7 splits, at 32 and at 24
    query heads over 8; B 8 in a grid of 5), bit-equal at each to the
    eager call at that int position.  Returns {check: passed}."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    kv, t, dh = 8, 2080, 128
    same, live = [], set()
    for b, n_split, h in ((1, None, 32), (8, 5, 32), (1, None, 24)):
        for dt in (FP32, BF16):
            q = _randn(gen, (b, h, dh), dt)
            k = _randn(gen, (b, t, kv, dh), dt)
            v = _randn(gen, (b, t, kv, dh), dt)
            pos_t = torch.zeros(1, dtype=torch.int64, device="cuda")

            def call(pos):
                if n_split is None:
                    return da_ops.decode_attention(q, k, v, pos)
                return _decode_split(q, k, v, pos, n_split)
            call(pos_t)
            torch.cuda.synchronize()
            with torch.cuda.graph(graph := torch.cuda.CUDAGraph()):  # repro-torch-check: disable=jit-in-loop -- one capture a (B, heads, dtype) case: the capture is what this check tests
                out = call(pos_t)
            plan = n_split or da_kernel.split_count(
                b, kv, h // kv, da_kernel.sm_count(0))
            for pos in (0, 63, 64, 300, 319, 320, 700, 1000, 1500, 2079):
                pos_t.fill_(pos)
                graph.replay()
                same.append(torch.equal(out, call(pos)))
                live.add((b, h, da_kernel.splits_of(pos, plan)[0]))
            del graph
    torch.cuda.synchronize()
    return {f"one captured launch replayed at 10 positions, bit-equal to "
            f"eager ({len(same)} cases, (B, H, live splits) "
            f"{sorted(live)})": all(same) and len(live) >= 6
            and any(h == 24 and n > 1 for _, h, n in live)}


def decode_split_checks(gen, checks):
    """K3 where several splits run, at llama3.1-8b's heads and a 2,080-slot
    cache: B 1 with the wrapper's own plan, B 8 (one split in its plan) cut
    into 2 and 5; pos at 0, around a split boundary and at T - 1: against
    the plain version (added to ``checks``), within 1e-6 (fp32) or one
    bf16 ulp of its arithmetic emulated in torch, bit-equal across two
    calls; NaN past pos in bf16 and NaN around strided views.  Returns
    {check: passed}."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.decode_attention.emulate import \
        decode_attention_split_emulated
    h, kv, t, dh = 32, 8, 2080, 128
    sms = da_kernel.sm_count(0)
    emulated, same, splits = [], [], set()
    for b, cap in ((1, None), (8, 2), (8, 5)):
        plan = (lambda p, b=b: da_kernel.split_plan(b, kv, h // kv, p,
                                                    sms)[0])
        for pos in _split_positions(t, cap or plan(t - 1)):
            n_split = cap or plan(pos)
            splits.add((b, da_kernel.splits_of(pos, n_split)[0]))
            for dt in (FP32, BF16):
                q = _randn(gen, (b, h, dh), dt)
                k = _randn(gen, (b, t, kv, dh), dt)
                v = _randn(gen, (b, t, kv, dh), dt)
                if cap is None:
                    got = da_ops.decode_attention(q, k, v, pos)
                    again = da_ops.decode_attention(q, k, v, pos)
                else:
                    got = _decode_split(q, k, v, pos, n_split)
                    again = _decode_split(q, k, v, pos, n_split)
                checks.add(("splits", b, pos, n_split), got,
                           _decode_want(q, k, v, pos), dt)
                same.append(torch.equal(got, again))
                want = decode_attention_split_emulated(q, k, v, pos, n_split)
                if dt == FP32:
                    emulated.append(bool(torch.isclose(
                        got, want, rtol=1e-6, atol=1e-6).all()))
                else:
                    _, e = torch.frexp(want.float().abs().clamp(min=1 / 16))
                    ulp = torch.ldexp(torch.ones_like(want, dtype=FP32), e - 8)
                    emulated.append(bool(((got.float() - want.float()).abs()
                                          <= ulp).all()))
    # NaN past pos where several splits run, bf16
    q = _randn(gen, (8, h, dh), BF16)
    k = _randn(gen, (8, t, kv, dh), BF16)
    v = _randn(gen, (8, t, kv, dh), BF16)
    clean = _decode_split(q, k, v, 1000, 5)
    k[:, 1001:], v[:, 1001:] = math.nan, math.nan
    nan_past = torch.equal(_decode_split(q, k, v, 1000, 5), clean)
    # q and the cache as strided views into buffers holding NaN around them
    for b, tt, pos in ((2, 130, 129), (8, 600, 575), (1, 2080, 2000)):
        for dt in (FP32, BF16):
            qbuf = torch.full((b, 40, dh + 16), math.nan, dtype=dt,
                              device="cuda")
            cbuf = torch.full((b, tt + 9, 19, dh + 16), math.nan, dtype=dt,
                              device="cuda")
            q = qbuf[:, 3:35, 8:8 + dh]
            k = cbuf[:, 4:4 + tt, 1:9, 8:8 + dh]
            v = cbuf[:, 4:4 + tt, 10:18, 8:8 + dh]
            for x in (q, k, v):
                x.copy_(_randn(gen, x.shape, dt))
            checks.add(("strided, NaN around", b, tt, pos),
                       da_ops.decode_attention(q, k, v, pos),
                       _decode_want(q, k, v, pos), dt)
    torch.cuda.synchronize()
    return {f"emulation within 1e-6 / 1 bf16 ulp ({len(emulated)} cases, "
            f"(B, n_split) {sorted(splits)})": all(emulated),
            f"bit-equal across two calls ({len(same)} cases)": all(same),
            "NaN past pos, bf16, 5 splits": nan_past}


def eager_generate(model, prompts, oo):
    """The decode loop as eager ``decode_step`` calls, greedy, timed as
    ``ServingEngine.generate`` times its graph replays: the yardstick of
    phase [6].  Returns thpt, prefill_s, decode_s and the tokens."""
    from repro_torch.inference.sampling import sample
    b, ii = prompts.shape
    vocab = model.cfg.vocab_size
    tokens = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    t0 = time.perf_counter()
    logits, cache = model.prefill(tokens, ii + oo)
    tok = sample(logits, vocab_size=vocab)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    toks = [tok]
    for _ in range(oo - 1):
        logits, cache = model.decode_step(cache, tok)
        tok = sample(logits, vocab_size=vocab)
        toks.append(tok)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return dict(thpt=b * oo / (t2 - t0), prefill_s=t1 - t0,
                decode_s=t2 - t1,
                tokens=torch.cat(toks, 1).cpu().numpy().astype(np.int32))


def k1_plan(rows, d, elt=2, sms=132):
    """How K1 cuts a row of ``d`` values of ``elt`` bytes
    (``csrc/rmsnorm.cu::launch``): 16-byte vectors, one row a block."""
    v = 16 // elt
    nvec = d // v
    if d % v or nvec > 4 * 1024:
        return "staged in shared memory"
    r = (1 if nvec <= 256 or (rows < sms and nvec <= 1024)
         else 2 if nvec <= 512 else 4)
    per = -(-nvec // r)
    threads = -(-per // 32) * 32
    return (f"{nvec} vectors as {r} a thread over {threads} threads "
            f"({threads * r - nvec} vector slots idle)")


def k1_timings(gen, rows, d):
    """K1 plain and fused over ``rows`` x ``d`` bf16 rows (scale fp32, as
    the model holds it), timed beside the plain versions, the library
    calls and a ``copy_`` of the same bytes."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref
    scale = torch.ones(d, device="cuda")
    wscale = scale.to(BF16)

    def rms_lib(t, *_):
        return torch.nn.functional.rms_norm(t, (d,), wscale, 1e-5)

    def add_rms_lib(t, r, _s):  # two calls: the add, then the norm
        return torch.nn.functional.rms_norm(t + r, (d,), wscale, 1e-5)

    out = []
    nbytes = 2 * rows * d * 2 + d * 4
    sets = [(_randn(gen, (rows, d), BF16), scale)
            for _ in range(_n_sets(nbytes))]
    x = sets[0][0]
    out.append(dict(
        name="rmsnorm", shape=f"{rows}x{d} bf16",
        check=(rms_ops.rmsnorm(x, scale), rmsnorm_ref(x, scale)),
        ms=time_ms(rms_ops.rmsnorm, sets),
        plain_ms=time_ms(rmsnorm_ref, sets),
        library_ms=time_ms(rms_lib, sets),
        device_ms=device_ms(rms_ops.rmsnorm, sets, "rmsnorm"),
        library_device_ms=device_ms(rms_lib, sets),
        library_call="F.rms_norm",
        copy_device_ms=_copy_device_ms(nbytes, len(sets)),
        bound=_bound(nbytes, rms_ops.rmsnorm_flops(rows, d), PEAK_FP32)))
    nbytes = 4 * rows * d * 2 + d * 4
    sets = [(_randn(gen, (rows, d), BF16), _randn(gen, (rows, d), BF16),
             scale) for _ in range(_n_sets(nbytes))]
    x, r, _ = sets[0]
    out.append(dict(
        name="add_rmsnorm", shape=f"{rows}x{d} bf16",
        check=(rms_ops.add_rmsnorm(x, r, scale)[1],
               add_rmsnorm_ref(x, r, scale)[1]),
        ms=time_ms(rms_ops.add_rmsnorm, sets),
        plain_ms=time_ms(add_rmsnorm_ref, sets),
        library_ms=None, two_call_ms=time_ms(add_rms_lib, sets),
        device_ms=device_ms(rms_ops.add_rmsnorm, sets, "rmsnorm"),
        library_device_ms=device_ms(add_rms_lib, sets),
        library_call="x + r, then F.rms_norm (two calls)",
        copy_device_ms=_copy_device_ms(nbytes, len(sets)),
        bound=_bound(nbytes, rms_ops.rmsnorm_flops(rows, d, fused=True),
                     PEAK_FP32)))
    return out


def k2_timing(gen, bb, sq, sk, h, kv, dh, causal, lse=False):
    """K2 at ``bb`` sequences of ``sq`` query rows against ``sk`` key rows,
    bf16, timed beside its plain version and SDPA (whose ``is_causal``
    is the same top-left mask where Sq != Sk); with ``lse`` as training
    calls it, keeping each row's log-sum-exp (checked is the output).  The
    bound counts each input read once, the outputs written once, and the
    products of the (row, key) pairs the mask keeps."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    nbytes = 2 * bb * (2 * sq * h + 2 * sk * kv) * dh + 4 * bb * h * sq * lse
    sets = [(_randn(gen, (bb, sq, h, dh), BF16),
             _randn(gen, (bb, sk, kv, dh), BF16),
             _randn(gen, (bb, sk, kv, dh), BF16))
            for _ in range(_n_sets(nbytes))]
    q, k, v = sets[0]

    def fa(q, k, v):
        if lse:
            return fa_ops.flash_attention_lse(q, k, v, causal=causal)[0]
        return fa_ops.flash_attention(q, k, v, causal=causal)

    def fa_plain(q, k, v):
        return _flash_want(q, k, v, causal)

    def fa_lib(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=causal, enable_gqa=True)

    rows = f"S{sq}" if sq == sk else f"Sq{sq} Sk{sk}"
    return dict(
        name="flash_attention",
        shape=(f"B{bb} {rows} H{h} KV{kv} Dh{dh} bf16"
               + ("" if causal else " full") + (" with lse" if lse else "")),
        check=(fa(q, k, v), fa_plain(q, k, v)),
        ms=time_ms(fa, sets), plain_ms=time_ms(fa_plain, sets),
        library_ms=time_ms(fa_lib, sets),
        device_ms=device_ms(fa, sets, "flash_fwd"),
        library_device_ms=device_ms(fa_lib, sets),
        bound=_bound(nbytes, fa_ops.flash_attention_flops(bb, sq, sk, h, dh,
                                                          causal),
                     PEAK_BF16))


def k3_timing(gen, bb, t, h, kv, dh, smi, by_split=False, tag="[4]"):
    """K3 at the last decode step of a ``t``-slot cache (pos t - 1), bf16,
    timed beside its plain version and SDPA over the live positions;
    prints its split plan, achieved bandwidth and (``by_split``) its
    device ms with the positions cut into 1, 2, 4 and 8 splits."""
    from repro_torch.kernels.decode_attention import kernel as da_kernel
    from repro_torch.kernels.decode_attention import ops as da_ops
    pos = t - 1
    nbytes = 2 * bb * h * dh * 2 + 2 * bb * (pos + 1) * kv * dh * 2
    sets = [(_randn(gen, (bb, h, dh), BF16),
             _randn(gen, (bb, t, kv, dh), BF16),
             _randn(gen, (bb, t, kv, dh), BF16))
            for _ in range(_n_sets(nbytes))]
    q, k, v = sets[0]

    def da(q, k, v):
        return da_ops.decode_attention(q, k, v, pos)

    def da_plain(q, k, v):
        return _decode_want(q, k, v, pos)

    def da_lib(q, k, v):
        return torch.nn.functional.scaled_dot_product_attention(
            q[:, :, None], k[:, :pos + 1].transpose(1, 2),
            v[:, :pos + 1].transpose(1, 2), enable_gqa=True)

    # K3 is one kernel a call: its device ms a launch, which a trace that
    # drops a kernel record does not lower (a sum over the calls would)
    g = h // kv
    n_split, rows = da_kernel.split_plan(bb, kv, g, pos,
                                         da_kernel.sm_count(0))
    tm = dict(
        name="decode_attention",
        shape=f"B{bb} T{t} pos{pos} H{h} KV{kv} Dh{dh} bf16",
        check=(da(q, k, v), da_plain(q, k, v)),
        ms=time_ms(da, sets), plain_ms=time_ms(da_plain, sets),
        library_ms=time_ms(da_lib, sets),
        device_ms=device_ms(da, sets, "decode_attn"),
        library_device_ms=device_ms(da_lib, sets),
        bound=_bound(nbytes, da_ops.decode_attention_flops(bb, h, dh, pos + 1),
                     PEAK_BF16))
    rate = nbytes / tm["device_ms"] / 1e6
    chunks = -(-g // da_kernel.HEADS_A_BLOCK)
    # the same call cut into other numbers of splits: what the plan
    # weighs (kernel.split_plan)
    by = "" if not by_split else "; device ms at n_split " + ", ".join(
        f"{n} {device_ms(lambda *x, n=n: _decode_split(*x, pos, n), sets):.4f}"
        for n in (1, 2, 4, 8))
    print(f"{tag} decode_attention B{bb} pos{pos} H{h} KV{kv} (G {g}): "
          f"n_split {n_split} of {rows} positions, grid ({kv * chunks}, "
          f"{bb}, {n_split}) = {kv * chunks * bb * n_split} blocks of 256 "
          f"threads in clusters of {n_split}, {g} of "
          f"{chunks * da_kernel.HEADS_A_BLOCK} head rows a block live; "
          f"{nbytes / 1e6:.2f} MB in {tm['device_ms']:.4f} device ms: "
          f"{rate:.0f} GB/s, {100 * rate / (PEAK_BYTES / 1e9):.1f}% of 3.35 "
          f"TB/s; SDPA {tm['library_device_ms']:.4f} device ms{by} [{smi}]")
    return tm


def print_timing(tag, tm, smi):
    """One line of a kernel's timing (``k1_timings``, ``k2_timing``,
    ``k3_timing`` and the K4 timings), its error already in ``err``."""
    bound_ms, bound_by = tm["bound"]
    lib_ms = tm["library_ms"] if tm["library_ms"] is not None \
        else tm.get("two_call_ms")
    library = ("none" if lib_ms is None else
               f"{tm.get('library_call', '')} {lib_ms:.4f} ms (device "
               f"{tm['library_device_ms']:.4f} ms a call)")
    copy = ("" if "copy_device_ms" not in tm else
            f", copy_ of the same bytes {tm['copy_device_ms']:.4f} "
            f"device ms")
    searched = ("" if "searched" not in tm else
                f", {tm['searched']} nodes searched")
    print(f"{tag} {tm['name']} {tm['shape']}: kernel {tm['ms']:.4f} ms "
          f"(device {tm['device_ms']:.4f} ms a call), bound "
          f"{bound_ms:.3g} ms ({bound_by}{searched}), plain "
          f"{tm['plain_ms']:.4f} ms, library {library}{copy}, max err "
          f"{tm['err']:.3g} [{smi}]")


def _step_counts(cfg, prefill=False):
    """K1 plain, K1 fused and attention launches of one forward of ``cfg``
    (a decode step; with ``prefill`` a prompt): one plain norm (block 0's
    norm1) and, with QK-norm, 2 an attention layer; 2 fused norms a block
    with an FFN (dense or MoE), 1 without (its mixer's add fused with the
    next norm), one more a decoder layer with cross attention (the
    mixer's add fused with cross_norm); K2/K3 once an attention layer,
    twice with cross attention.  An encoder-decoder model's prompt also
    runs the encoder: one plain norm, 2 fused norms and one K2 a layer."""
    n_attn = sum(b.mixer == "attn" for b in cfg.period) * cfg.n_periods
    cross = int(cfg.is_encdec)
    fused = sum(2 if b.ffn == "moe" or (b.ffn == "dense" and cfg.d_ff > 0)
                else 1 for b in cfg.period) * cfg.n_periods
    plain = 1 + 2 * n_attn * cfg.qk_norm
    fused, attn = fused + cross * cfg.n_layers, n_attn * (1 + cross)
    if prefill and cross:
        plain, fused = plain + 1, fused + 2 * cfg.n_encoder_layers
        attn += cfg.n_encoder_layers
    return plain, fused, attn


def _frontend_inputs(cfg, b, text, seed, device="cpu"):
    """What a prefill of ``b`` prompts of ``text`` tokens takes besides
    them, drawn by ``models.io.make_batch``: {} for a text-only model,
    whisper's ``frames`` or internvl2's ``patches``; and the positions the
    sequence takes (the patches come first)."""
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.io import make_batch
    seq = text + (cfg.n_patches if cfg.frontend == "vision" else 0)
    if cfg.frontend == "none":
        return {}, seq
    batch = make_batch(cfg, ShapeSpec("prefill", seq, b, "prefill"), seed,
                       device)
    batch.pop("tokens")
    return batch, seq


def _served(model, toks, steps, extra=None, seq=None):
    """Last-token logits of a prefill of ``toks`` (with ``extra``, the
    frames or patches; ``seq`` positions in all) and a decode step for
    each of ``steps``, as float32 on the host."""
    dev = model.device
    seq = seq or toks.shape[1]
    logits, cache = model.prefill(toks.to(dev), seq + len(steps),
                                  **{k: t.to(dev) for k, t in
                                     (extra or {}).items()})
    out = [logits.float().cpu()]
    for tok in steps:
        logits, cache = model.decode_step(cache, tok.to(dev))
        out.append(logits.float().cpu())
    return out


def model_checks(tag, label, cfg, hold=BF16) -> bool:
    """One model on the card through the kernels against the same weights
    on the CPU through the plain versions, prefill of 2 x 64 tokens (and
    the frames or patches an encoder-decoder or vision model takes) and 4
    decode steps: in bf16 within 2e-2, or (``hold`` FP32) computed in
    fp32 on the bf16 weights within 1e-3, where bf16 rounding alone
    moves the model's logits by more than 2e-2 (the CPU's own bf16
    against its fp32 is printed beside it).  Then its decode step
    replayed as a CUDA graph against 16 eager greedy steps, logits, tokens,
    recurrent states and cross K/V bit for bit, and the captured step's K1
    and K3 nodes counted from the graph (``_step_counts``); the first eager
    step
    runs under ``torch.cuda.set_sync_debug_mode("error")``, which raises
    at a synchronisation with the host."""
    from repro_torch.inference.engine import DecodeGraph
    from repro_torch.inference.sampling import sample
    from repro_torch.models.transformer import Model
    t0 = time.perf_counter()
    card = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
    weights = dict(card.named_parameters())
    cpu = Model(cfg).load({n: p.cpu() for n, p in weights.items()})
    t_copy = time.perf_counter() - t0
    cpu_gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=cpu_gen)
    steps = torch.randint(0, cfg.vocab_size, (4, 2, 1), generator=cpu_gen)
    extra, seq = _frontend_inputs(cfg, 2, 64, seed=1)
    got = _served(card, toks, steps, extra, seq)
    want = _served(cpu, toks, steps, extra, seq)
    note = ""
    if hold is FP32:
        c32 = cfg.scaled(compute_dtype=FP32)
        bf_errs = [_err(g, w) for g, w in zip(got, want)]
        got = _served(Model(c32).load({n: p.float() for n, p in
                                       weights.items()}), toks, steps,
                      extra, seq)
        want32 = _served(Model(c32).load({n: p.float() for n, p in
                                          cpu.named_parameters()}),
                         toks, steps, extra, seq)
        own = max(_err(b, w) for b, w in zip(want, want32))
        want = want32
        note = (f"; in bf16, as served: card vs CPU max err "
                f"{max(bf_errs):.3g}, the CPU's own bf16 logits "
                f"{own:.3g} from its fp32 ones (not gated)")
    tol = MODEL_TOL[hold]
    errs = [_err(g, w) for g, w in zip(got, want)]
    ok = all(bool(torch.isclose(g, w, rtol=tol, atol=tol).all())
             for g, w in zip(got, want)) \
        and all(bool(torch.isfinite(g).all()) for g in got)
    heads = ("" if cfg.attention_free else
             f", {cfg.n_heads}/{cfg.n_kv_heads} heads")
    what = "bf16" if hold is BF16 else "fp32 on the bf16 weights"
    print(f"{tag} {label} (d {cfg.d_model}{heads}, {cfg.n_layers} layers), "
          f"card vs CPU in {what}: last-token logits max err "
          f"prefill {errs[0]:.3g}, decode "
          f"{', '.join(f'{e:.3g}' for e in errs[1:])} (tol {tol:g})"
          f"{note}: {'ok' if ok else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s, {t_copy:.1f} s of it "
          f"drawing and copying to the CPU)")
    del cpu, weights
    # the same model's decode step replayed as a CUDA graph against 16
    # eager greedy steps from the same prompt: logits and tokens bit for bit
    graph = DecodeGraph(card, 2, seq + 17)
    prompt = toks.cuda()
    extra = {k: t.cuda() for k, t in extra.items()}
    logits, ecache = card.prefill(prompt, seq + 17, **extra)
    tok = sample(logits, vocab_size=cfg.vocab_size)
    eager, synced = [], "none"
    torch.cuda.synchronize()
    for n in range(16):
        if n == 0:
            torch.cuda.set_sync_debug_mode("error")
        try:
            logits, ecache = card.decode_step(ecache, tok)
            tok = sample(logits, vocab_size=cfg.vocab_size)
        except RuntimeError as e:  # a host sync in the "error" mode
            synced = f"FAIL {str(e)[:120]}"
            break
        finally:
            torch.cuda.set_sync_debug_mode("default")
        eager.append((logits.clone(), tok))
    logits, _ = card.prefill(prompt, cache=graph.cache, **extra)
    graph.start(sample(logits, vocab_size=cfg.vocab_size))
    same = []
    for logits, tok in eager:
        graph.replay()
        same.append(torch.equal(graph.logits, logits)
                    and torch.equal(graph.tok, tok))
    states = all(torch.equal(a, b) for st, ref in zip(graph.cache.blocks,
                                                      ecache.blocks)
                 if type(st).__name__ != "KVCache" for a, b in zip(st, ref))
    cross = all(torch.equal(a, b) for st, ref in zip(graph.cache.cross or (),
                                                     ecache.cross or ())
                for a, b in zip(st, ref))
    names = graph.kernel_names()
    nodes = tuple(sum(k in n for n in names) for k in ("rmsnorm",
                                                       "decode_attn"))
    plain, fused, n_attn = _step_counts(cfg)
    want_nodes = (plain + fused, n_attn)
    okg = (all(same) and len(same) == 16 and states and cross
           and int(graph.cache.pos_t) == seq + 16 and nodes == want_nodes)
    print(f"{tag} {label}, 16 graph replays against 16 eager steps: "
          f"logits and tokens bit-equal at {sum(same)} of {len(same)} "
          f"steps, recurrent states bit-equal {states}"
          + (f", cross K/V bit-equal {cross}" if cfg.is_encdec else "")
          + "; the captured "
          f"step's K1/K3 nodes {nodes}, expected {want_nodes}, of "
          f"{len(names)} kernel nodes; host syncs in an eager step: "
          f"{synced}: {'ok' if okg else 'FAIL'}")
    del card, graph, ecache
    return ok and okg


def _depth(arch, layers):
    """(label, config) of ``arch`` at full width and ``layers`` layers
    (None: all of them)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if layers is None:
        return f"{arch} whole", cfg
    return (f"{arch} {layers} of {cfg.n_layers} layers",
            cfg.scaled(n_layers=layers))


def mamba_block_check(smi) -> bool:
    """jamba's Mamba mixer at full width (d 8192, d_inner 16,384, d_state
    16), one block, seeded weights: a prefill of 2 x 64 tokens (4 chunks
    of 16) and 4 decode steps on the card against the same weights and
    inputs on the CPU, outputs and both states (bf16 within 2e-2)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    cfg = get_config(JAMBA)
    p = ssm.init_mamba(cfg, torch.Generator("cuda").manual_seed(0))
    pc = {k: v.cpu() for k, v in p.items()}
    x = torch.randn((2, 68, cfg.d_model),
                    generator=torch.Generator().manual_seed(1)).to(BF16)
    errs, ok = [], True

    def held(got, want):
        nonlocal ok
        (gy, gs), (cy, cs) = got, want
        errs.append(max(_err(a.cpu(), b)
                        for a, b in ((gy, cy), *zip(gs, cs))))
        ok = ok and all(_close(a.cpu(), b, BF16)
                        for a, b in ((gy, cy), *zip(gs, cs)))
        return gs, cs

    with torch.inference_mode():
        ssm.mamba_full(cfg, p, x[:, :64].cuda())  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ssm.mamba_full(cfg, p, x[:, :64].cuda())
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        gs, cs = held(got, ssm.mamba_full(cfg, pc, x[:, :64]))
        for t in range(64, 68):
            gs, cs = held(ssm.mamba_decode(cfg, p, x[:, t:t + 1].cuda(), gs),
                          ssm.mamba_decode(cfg, pc, x[:, t:t + 1], cs))
    n = sum(t.numel() for t in p.values())
    print(f"[14] {JAMBA} Mamba mixer at full width (d {cfg.d_model}, "
          f"d_inner {cfg.mamba_d_inner}, d_state {cfg.mamba_d_state}, "
          f"{n / 1e6:.1f} M parameters), card vs CPU: output and state max "
          f"err prefill {errs[0]:.3g}, decode "
          f"{', '.join(f'{e:.3g}' for e in errs[1:])} (bf16 tol 2e-2, the "
          f"fp32 SSM state too); a 2 x 64 prefill {prefill_ms:.2f} "
          f"ms: {'ok' if ok else 'FAIL'} [{smi}]")
    return ok


def moe_plain(cfg, p, x):
    """The MoE FFN as a plain loop over experts, independent of the sort
    and scatter of ``models.moe``: the first k experts by repeated argmax
    (the first maximum, so ties go to the lower index), renormalised;
    each expert's tokens found with a boolean mask, in token order, its
    first ``cap`` kept, run through its SwiGLU with ``torch.matmul`` and
    added gate-weighted into their rows.  Syncs with the host.  Returns
    (y, kept (T, k) bool)."""
    xt = x.reshape(-1, cfg.d_model)
    n, k = xt.shape[0], cfg.top_k
    cap = max(8, -(-int(cfg.capacity_factor * k * n / cfg.n_experts) // 8)
              * 8)
    probs = torch.softmax((xt @ p["router"]).float(), dim=-1)
    left, idx = probs.clone(), []
    for _ in range(k):
        idx.append(left.argmax(-1))
        left.scatter_(1, idx[-1][:, None], -1.0)
    idx = torch.stack(idx, 1)
    gate = probs.gather(1, idx)
    if k > 1:
        gate = gate / gate.sum(-1, keepdim=True)
    w = p["experts"]
    y = torch.zeros_like(xt)
    kept = torch.zeros_like(idx, dtype=torch.bool)
    for e in range(cfg.n_experts):
        hit = idx == e
        tokens = hit.any(1).nonzero()[:cap, 0]
        if len(tokens):
            choice = hit[tokens].int().argmax(1)
            kept[tokens, choice] = True
            xe = xt[tokens]
            h = torch.nn.functional.silu(torch.matmul(xe, w["w_gate"][e])) \
                * torch.matmul(xe, w["w_up"][e])
            out = torch.matmul(h, w["w_down"][e])
            y[tokens] += out * gate[tokens, choice].to(xt.dtype)[:, None]
    return y.view_as(x), kept


def moe_block_check(smi) -> bool:
    """jamba's MoE FFN at full width (16 experts of d_ff 24,576, top-2,
    19.3 GB), one block, on the card against ``moe_plain`` on the card,
    over MOE_TOKENS tokens: seeded router, then a zeroed one, which sends
    every token to experts 0 and 1 and overflows their capacity.  The
    entries kept are the plain loop's, the tokens dropped whole give
    exactly zero in both, the rest agree within bf16 2e-2."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config(JAMBA)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    p = moe.init_moe(cfg, torch.Generator("cuda").manual_seed(0))
    peak = torch.cuda.max_memory_allocated()
    x = _randn(torch.Generator("cuda").manual_seed(1),
               (1, MOE_TOKENS, cfg.d_model), BF16)
    cap = moe.expert_capacity(cfg, MOE_TOKENS)
    ok = True
    with torch.inference_mode():
        for which, params in (("seeded router", p),
                              ("zeroed router", dict(
                                  p, router=torch.zeros_like(p["router"])))):
            y, _ = moe.moe_ffn(cfg, params, x)
            want, kept_plain = moe_plain(cfg, params, x)
            xt = x.reshape(-1, cfg.d_model)
            _, _, idx = moe.route(cfg, params["router"], xt)
            _, order, _, keep = moe.dispatch(cfg, idx, cap)
            kept = torch.empty_like(keep)
            kept[order] = keep
            kept = kept.view(idx.shape)
            dropped = ~kept.any(1)
            y2, want2 = y.reshape(-1, cfg.d_model), want.reshape(
                -1, cfg.d_model)
            good = (torch.equal(kept, kept_plain)
                    and bool((y2[dropped] == 0).all())
                    and bool((want2[dropped] == 0).all())
                    and _close(y, want, BF16)
                    and bool(torch.isfinite(y).all()))
            if which == "zeroed router":
                good = good and bool((idx == torch.arange(
                    cfg.top_k, device=idx.device)).all()) \
                    and int(dropped.sum()) == MOE_TOKENS - cap
            ok = ok and good
            print(f"[14] {JAMBA} MoE FFN at full width, {which}, "
                  f"{MOE_TOKENS} tokens: capacity {cap}, entries kept "
                  f"{int(kept.sum())} of {kept.numel()} (the plain loop's: "
                  f"{torch.equal(kept, kept_plain)}), tokens dropped whole "
                  f"{int(dropped.sum())}, their output exactly zero; max "
                  f"err against the plain loop {_err(y, want):.3g} (bf16 "
                  f"tol 2e-2): {'ok' if good else 'FAIL'}")
        ms = time_ms(lambda x: moe.moe_ffn(cfg, p, x), [(x,)], iters=5)
        plain_ms = time_ms(lambda x: moe_plain(cfg, p, x), [(x,)], iters=2)
    flops = 2 * 3 * cfg.n_experts * cap * cfg.d_model * cfg.expert_d_ff
    nbytes = sum(t.numel() * t.element_size()
                 for t in (p["router"], *p["experts"].values()))
    bound_ms, by = _bound(nbytes, flops, PEAK_BF16)
    print(f"[14] {JAMBA} MoE FFN: {nbytes / 1e9:.2f} GB of weights, peak "
          f"while drawn {peak / 1e9:.2f} GB; a call over {MOE_TOKENS} "
          f"tokens {ms:.2f} ms (every expert's {cap} slots: bound "
          f"{bound_ms:.2f} ms, {by}), the plain loop {plain_ms:.2f} ms "
          f"[{smi}]")
    del p
    gc.collect()
    torch.cuda.empty_cache()
    return ok


def blocks_phase(smi):
    """Phase 14: the MoE and recurrent blocks (BLOCK_CHECKS, jamba's blocks,
    BLOCK_MEASURE).  Returns (ok, {kernel: launches} of (c))."""
    from repro_torch.configs import get_smoke_config
    ok = True
    for arch, layers, hold in BLOCK_CHECKS:
        label, cfg = _depth(arch, layers)
        ok = model_checks("[14]", label, cfg, hold) and ok
        gc.collect()
        torch.cuda.empty_cache()
    ok = model_checks("[14]", f"{JAMBA} smoke size",
                      get_smoke_config(JAMBA), FP32) and ok
    ok = mamba_block_check(smi) and ok
    ok = moe_block_check(smi) and ok
    good, launches, _ = measure_phase(
        "[14]", smi, [(arch, _depth(arch, layers)[1])
                      for arch, layers in BLOCK_MEASURE])
    return ok and good, launches


def encdec_kernel_checks(gen):
    """Phase 15 (a): K2 with a key length of its own, at the encoder's
    S = Sk = 1,500 and on strided views with NaN around them; K3 over a
    1,500-slot cache; K1 at d 896; each against its plain version.
    Returns ok."""
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref

    fa_c, da_c = Checks("flash_attention"), Checks("decode_attention")
    rms_c, add_c, sums = Checks("rmsnorm"), Checks("add_rmsnorm"), []
    for h, kv in ENCDEC_HEADS:
        shapes = [(sq, sk) for sq in CROSS_SQ for sk in CROSS_SK]
        for sq, sk in shapes + [(1500, 1500)]:
            for causal in (True, False):
                for dt in (FP32, BF16):
                    q = _randn(gen, (2, sq, h, 64), dt)
                    k = _randn(gen, (2, sk, kv, 64), dt)
                    v = _randn(gen, (2, sk, kv, 64), dt)
                    fa_c.add((f"Sq {sq} Sk {sk} H {h} KV {kv}", causal),
                             fa_ops.flash_attention(q, k, v, causal=causal),
                             _flash_want(q, k, v, causal), dt)
    # q and k/v as strided views of buffers of other lengths whose other
    # rows, heads and columns hold NaN: a read past Sq or Sk shows
    for sq, sk in ((65, 1500), (129, 70)):
        for causal in (True, False):
            for dt in (FP32, BF16):
                qbuf = torch.full((2, sq + 5, 10, 80), math.nan, dtype=dt,
                                  device="cuda")
                kbuf = torch.full((2, sk + 7, 6, 80), math.nan, dtype=dt,
                                  device="cuda")
                q = qbuf[:, 2:2 + sq, 1:9, 8:72]
                k, v = kbuf[:, 3:3 + sk, 0:2, 8:72], kbuf[:, 3:3 + sk, 3:5, 8:72]
                for x in (q, k, v):
                    x.copy_(_randn(gen, x.shape, dt))
                fa_c.add(("strided, NaN around", sq, sk, causal),
                         fa_ops.flash_attention(q, k, v, causal=causal),
                         _flash_want(q, k, v, causal), dt)
    # K3 over the encoder's 1,500 frames, the position a device tensor
    for h, kv in ENCDEC_HEADS:
        for b in (1, 16):
            for pos in (0, 700, 1499):
                for dt in (FP32, BF16):
                    q = _randn(gen, (b, h, 64), dt)
                    k = _randn(gen, (b, 1500, kv, 64), dt)
                    v = _randn(gen, (b, 1500, kv, 64), dt)
                    pos_t = torch.full((1,), pos, dtype=torch.int64,
                                       device="cuda")
                    da_c.add((b, h, kv, 1500, pos),
                             da_ops.decode_attention(q, k, v, pos_t),
                             _decode_want(q, k, v, pos), dt)
    # K1 at internvl2's width: a decode step's rows, a prefill's
    for rows in (8, 2048, 16 * (256 + 512)):
        for dt in (FP32, BF16):
            for sdt in (FP32, BF16):
                x, r = (_randn(gen, (rows, WIDTH_VLM), dt) for _ in range(2))
                scale = _randn(gen, (WIDTH_VLM,), sdt)
                rms_c.add((rows, WIDTH_VLM), rms_ops.rmsnorm(x, scale),
                          rmsnorm_ref(x, scale), dt)
                (s_got, y_got), (s_want, y_want) = (
                    rms_ops.add_rmsnorm(x, r, scale),
                    add_rmsnorm_ref(x, r, scale))
                add_c.add((rows, WIDTH_VLM), y_got, y_want, dt)
                sums.append(torch.equal(_bits(s_got), _bits(s_want)))
    ok = all([c.report("[15]") for c in (fa_c, da_c, rms_c, add_c)])
    print(f"[15] add_rmsnorm at d {WIDTH_VLM}: s bit for bit x + r in "
          f"{sum(sums)} of {len(sums)} cases: "
          f"{'ok' if all(sums) else 'FAIL'}")
    return ok and all(sums)


def encdec_phase(smi):
    """Phase 15: whisper-medium's encoder-decoder path and internvl2-1b's
    vision stub: the kernels at their new shapes against their plain
    versions and timed (bf16, at the whole models' cell (512, 32, 16):
    the encoder's 1,500 frames, the cross prefill, internvl2's prefill of
    256 patches and 512 tokens, cross and self decode steps, K1 over
    internvl2's prefill rows), both models at 2 layers card against CPU
    (``model_checks``), then both whole through ``measure_arch``
    (``measure_phase``).  Returns (ok, {kernel: launches} of the whole
    models' main path)."""
    from repro_torch.configs import get_config
    gen = torch.Generator("cuda").manual_seed(15)
    ok = encdec_kernel_checks(gen)
    (h1, kv1), (h7, kv7) = ENCDEC_HEADS
    timings = [k2_timing(gen, 16, 1500, 1500, h1, kv1, 64, False),
               k2_timing(gen, 16, 512, 1500, h1, kv1, 64, False),
               k2_timing(gen, 16, 256 + 512, 256 + 512, h7, kv7, 64, True),
               k3_timing(gen, 16, 1500, h1, kv1, 64, smi, tag="[15]"),
               k3_timing(gen, 16, 512 + 32, h1, kv1, 64, smi, tag="[15]"),
               k3_timing(gen, 16, 256 + 512 + 32, h7, kv7, 64, smi,
                         tag="[15]"),
               *k1_timings(gen, 16 * (256 + 512), WIDTH_VLM)]
    for tm in timings:
        got, want = tm.pop("check")
        tm["err"] = _err(got, want)
        ok = _close(got, want, BF16) and ok
        print_timing("[15]", tm, smi)
    del timings
    torch.cuda.empty_cache()
    for arch, cut in ENCDEC:
        cfg = get_config(arch)
        label = (f"{arch} at {cut['n_layers']} of {cfg.n_layers} layers"
                 + (f" and {cut['n_encoder_layers']} of "
                    f"{cfg.n_encoder_layers} encoder layers"
                    if "n_encoder_layers" in cut else ""))
        ok = model_checks("[15]", label, cfg.scaled(**cut), FP32) and ok
        gc.collect()
        torch.cuda.empty_cache()
    good, launches, _ = measure_phase(
        "[15]", smi, [(arch, get_config(arch)) for arch, _ in ENCDEC])
    return ok and good, launches


# kernel kinds of a traced decode step, by name
STEP_KINDS = (("K1", ("rmsnorm",)), ("K3", ("decode_attn",)),
              ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")),
              ("sort", ("sort", "radix")),
              ("gather/scatter", ("index", "scatter", "gather")))


def trace_replays(tag, arch, model, graph, prompts, smi, extra=None):
    """Traces 8 replays of ``graph`` (a warm-up pass of 8 first) from a
    prefill of ``prompts`` (and ``extra``, the frames or patches) into its
    cache: wall and device-busy ms, the device ms by kernel kind
    (STEP_KINDS; the rest elementwise and reductions) and the top
    kernels."""
    toks = torch.as_tensor(prompts, dtype=torch.int64, device="cuda")
    model.prefill(toks, cache=graph.cache,
                  **{k: torch.as_tensor(a).to("cuda", model.cfg.compute_dtype)
                     for k, a in (extra or {}).items()})
    graph.start(toks[:, -1:])

    def replay8():
        for _ in range(8):
            graph.replay()

    wall, busy, top, _, _ = _device_profile(replay8, warm=True)
    kinds, rest = {}, 0.0
    for name, n, ms in top:
        kind = next((k for k, keys in STEP_KINDS
                     if any(key in name.lower() for key in keys)), None)
        if kind is None:
            rest += ms
        else:
            kinds[kind] = kinds.get(kind, 0.0) + ms
    print(f"{tag} {arch}, 8 graph replays traced: wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / wall:.1f}%); device ms "
          f"a step by kind: "
          + ", ".join(f"{k} {v / 8:.3f}" for k, v in kinds.items())
          + f", other {rest / 8:.3f}; top kernels: "
          + "; ".join(f"{name[:48]} x{n} {ms / 8:.3f} ms a step"
                      for name, n, ms in top[:6]) + f" [{smi}]")


def _step_bytes(model, bb, live):
    """Bytes a decode step of ``bb`` sequences reads at least, with
    ``live`` cache positions: the decoder's weights (not the encoder's,
    the vision projection or cross attention's K/V projections, which run
    at prefill only; the embedding table once, as the tied LM head, or
    else the untied head and not the table, of which a step reads bb
    rows), the self K/V of the attention layers up to ``live`` and, with
    an encoder, all of the cross K/V.  None for recurrent blocks, whose
    states this does not count."""
    cfg = model.cfg
    if cfg.subquadratic:
        return None
    skip = ("enc_blocks.", "enc_norm.", "vis_proj")
    weights = sum(p.numel() * p.element_size()
                  for n, p in model.named_parameters()
                  if not n.startswith(skip)
                  and not n.endswith((".cross_attn.wk", ".cross_attn.wv"))
                  and not (n == "embed.tok_embed" and not cfg.tie_embeddings))
    n_attn = sum(b.mixer == "attn" for b in cfg.period) * cfg.n_periods
    pos_bytes = (2 * bb * cfg.n_kv_heads * cfg.d_head
                 * cfg.compute_dtype.itemsize)
    cross = (cfg.n_layers * pos_bytes * cfg.encoder_seq if cfg.is_encdec
             else 0)
    return weights, n_attn * pos_bytes * live, cross


def measure_phase(tag, smi, models):
    """Each ``(arch, cfg)`` of ``models`` at full width (phase [10]: the
    newer dense configs at full depth; phase [14]: the MoE and recurrent
    ones, depth cut to fit; phase [15]: whisper-medium and internvl2-1b
    whole, their stub frames or patches drawn with each request's
    prompts), seeded random weights, through ``measure_arch`` over phase
    [8]'s grid (the graphed engine), its launches held to
    ``_step_counts``; each model, its caches and its decode graphs freed
    before the next is drawn; a graphed decode step at the step cell
    beside the bytes it reads (``_step_bytes``) and 8 of its replays
    traced (``trace_replays``).  Returns (ok, {kernel: launches}, {arch:
    rows})."""
    from repro_torch.bench.harness import measure_arch
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models import io
    from repro_torch.inference.engine import ServingEngine
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models.transformer import Model
    counters = (rms_ops.rmsnorm, rms_ops.add_rmsnorm, fa_ops.flash_attention,
                da_ops.decode_attention)
    launches = {fn.__name__: 0 for fn in counters}
    cells = (len(MEASURE_GRID["grid_ii"]) * len(MEASURE_GRID["grid_oo"])
             * len(MEASURE_GRID["grid_bb"]))
    ok, out = True, {}
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    print(f"{tag} {held / 1e9:.2f} GB allocated on the card before the first "
          f"model")
    for arch, cfg in models:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = Model(cfg).init(torch.Generator("cuda").manual_seed(0))
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        weights, init_peak = (torch.cuda.memory_allocated(),
                              torch.cuda.max_memory_allocated())
        # the main path: counters zeroed just before, read just after
        for fn in counters:
            fn.launches = 0
        t1 = time.perf_counter()
        rows = measure_arch(arch, model=model, **MEASURE_GRID)
        t_measure = time.perf_counter() - t1
        grew = [fn.launches for fn in counters]
        for fn in counters:
            launches[fn.__name__] += fn.launches
        # a decode step's time at the grid's largest decode cell
        cell = (min(MEASURE_GRID["grid_ii"]), max(MEASURE_GRID["grid_oo"]),
                max(MEASURE_GRID["grid_bb"]))
        engine = ServingEngine(model)
        seq = model.n_prefix + cell[0]
        extra = io.draw(cfg, ShapeSpec("step", seq, cell[2], "prefill"),
                        np.random.default_rng(1))
        prompts = extra.pop("tokens")
        res = engine.generate(prompts, cell[1], inputs=extra)
        step = res.decode_s / (cell[1] - 1)
        encoder = ""
        if cfg.is_encdec:  # the prefill's encoder alone, warm
            frames = torch.as_tensor(extra["frames"]).to("cuda", BF16)
            for _ in range(2):
                torch.cuda.synchronize()
                t2 = time.perf_counter()
                model.encode(frames)
                torch.cuda.synchronize()
            encoder = (f" (the encoder over {cfg.encoder_seq} frames "
                       f"{1e3 * (time.perf_counter() - t2):.1f} ms of it "
                       f"alone)")
            del frames
        # a cell: warm-up and reps prefills, one capture after one eager
        # step; K1 and K2 as _step_counts a prompt, K1 and K3 a step
        first, then = _step_counts(cfg, prefill=True), _step_counts(cfg)
        pre = (1 + MEASURE_GRID["reps"]) * cells
        expect = [first[0] * pre + then[0] * 2 * cells,
                  first[1] * pre + then[1] * 2 * cells, first[2] * pre,
                  then[2] * 2 * cells]
        ii, oo, bb, thpt = rows.workload
        good = (len(rows) == cells * MEASURE_GRID["reps"] and grew == expect
                and bool(np.all(np.isfinite(thpt) & (thpt > 0)))
                and set(rows["acc"]) == {"gpu-h100-sxm"})
        ok = ok and good
        blocks = (f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}"
                  if not cfg.n_experts else
                  f"{cfg.n_heads}/{cfg.n_kv_heads} heads, {cfg.n_experts} "
                  f"experts of d_ff {cfg.expert_d_ff}, top-{cfg.top_k}")
        if cfg.attention_free:
            blocks = "+".join(b.mixer for b in cfg.period) + " blocks"
        if cfg.is_encdec:
            blocks += (f", {cfg.n_encoder_layers} encoder layers over "
                       f"{cfg.encoder_seq} frames")
        elif model.n_prefix:
            blocks += f", {model.n_prefix} patches before the prompt"
        # the steps of the timed run read pos + 1 positions at pos = seq
        # .. seq + oo - 2: seq + oo / 2 on average
        read = _step_bytes(model, cell[2], seq + cell[1] / 2)
        bound = "" if read is None else (
            f" (bound {1e3 * sum(read) / PEAK_BYTES:.3f} ms: "
            f"{sum(read) / 1e9:.2f} GB at 3.35 TB/s, of it weights "
            f"{read[0] / 1e9:.2f}, self K/V {read[1] / 1e9:.2f}"
            + (f", cross K/V {read[2] / 1e9:.2f}" if read[2] else "") + ")")
        print(f"{tag} {arch}: {n_params / 1e9:.4f} B parameters "
              f"({cfg.n_layers} layers, d {cfg.d_model}, {blocks}, vocab "
              f"{cfg.vocab_size}), weights {weights / 1e9:.2f} GB, peak "
              f"while drawn {init_peak / 1e9:.2f} GB, init {t_init:.1f} s; "
              f"measure_arch {len(rows)} rows in {t_measure:.1f} s, peak "
              f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"thpt {thpt.min():.1f} to {thpt.max():.1f} tok/s; a graphed "
              f"decode step at (ii, oo, bb) = {cell} {1e3 * step:.3f} ms"
              f"{bound}, its prefill {1e3 * res.prefill_s:.1f} ms{encoder} "
              f"[{smi}]")
        for a in MEASURE_GRID["grid_ii"]:
            for o in MEASURE_GRID["grid_oo"]:
                m = (ii == a) & (oo == o)
                print(f"{tag}   {arch} (ii, oo) = ({a}, {o}): thpt at bb "
                      f"{'/'.join(f'{b:g}' for b in bb[m])}: "
                      f"{', '.join(f'{t:.1f}' for t in thpt[m])}")
        print(f"{tag} {arch} launches rmsnorm/add_rmsnorm/flash/decode: "
              f"{grew}, expected {expect}: {'ok' if good else 'FAIL'}")
        trace_replays(tag, arch, model, engine.decode_graph(
            cell[2], seq + cell[1]), prompts, smi, extra)
        out[arch] = rows
        del model, engine
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches, out


def _k4_counters():
    from repro_torch.core import fit, gbt
    from repro_torch.kernels.gbt_hist import ops as gh_ops
    return {"gbt_hist": (gh_ops.build_node_histograms, "launches"),
            "gbt_split": (gh_ops.split_level, "launches"),
            "gbt_grow": (gh_ops.grow_fit, "launches"),
            "fits": (gbt.grow_forests, "fits"),
            "levels": (gbt.grow_forests, "levels"),
            "host_levels": (gbt._joint_histograms, "levels"),
            "solves": (fit._solve_padded, "solves")}


def _zero_k4():
    for fn, attr in _k4_counters().values():
        setattr(fn, attr, 0)


def _read_k4():
    """{K4 kernel: launches; "fits": fits grown on the card, "levels": their
    tree levels, "host_levels": levels of the host loop, "solves": LM
    solves}."""
    return {k: getattr(fn, attr) for k, (fn, attr) in _k4_counters().items()}


def _one_launch_a_fit(k4) -> bool:
    """Every fit grown on the card was one gbt_grow launch, with no launch
    a level and no level by the host loop."""
    return (k4["gbt_grow"] == k4["fits"] and k4["gbt_hist"] == 0
            and k4["gbt_split"] == 0 and k4["host_levels"] == 0)


def _rows_of(data, keys, combo):
    arr = np.stack([data[k].astype(str) for k in keys], axis=1)
    return data.mask(np.all(arr == np.asarray(combo), axis=1))


def _relabel(data, acc):
    from repro_torch.core.dataset import Dataset
    return Dataset({**data.cols, "acc": np.full(len(data), acc)})


def lm_checks(data, keys, card, cpu, device=None) -> dict:
    """Phase 11's databases: the LM contract (``core.fit.lm_agreement``),
    the card's curves at each group's batch sizes against the CPU's:
    within 1e-3 relative where the CPU's fit has converged (within 1e-4
    of the float64 optimum), elsewhere (the float32 LM stopped in a flat
    valley after its 60 steps) within 2e-2, and fewer than a tenth of all
    groups beyond 1e-3.  Then the controls, the LM on ``device`` (None:
    the GPU) in bf16 and cut to 20 steps, which the same comparison must
    refuse.  Returns {check: passed}."""
    from repro_torch.core.database import exponential_groups
    from repro_torch.core.expmodel import exp_model
    from repro_torch.core.fit import (BEYOND_SHARE, CONVERGED_RTOL,
                                      CURVE_RTOL, UNCONVERGED_RTOL, _pow2,
                                      fit_exponential_groups, lm_agreement,
                                      lm_optimum)
    checks = {}
    groups, got, want, pads = [], [], [], []
    same_keys = list(card.combos) == list(cpu.combos)
    for combo, cm in cpu.combos.items():
        cdb = card.combos[combo].db
        if cm.db is None or cdb is None:
            same_keys = same_keys and cm.db is cdb
            continue
        uniq, kept, gs = exponential_groups(
            *_rows_of(data, keys, combo).workload)
        gkeys = [(float(uniq[g, 0]), float(uniq[g, 1])) for g in kept]
        same_keys = same_keys and list(cdb.params) == list(cm.db.params) \
            == gkeys
        if not same_keys:
            break
        groups += gs
        got += [cdb.params[k] for k in gkeys]
        want += [cm.db.params[k] for k in gkeys]
        pads += [_pow2(max(len(g[0]) for g in gs))] * len(gs)
    t0 = time.perf_counter()
    opt = lm_optimum(groups, max(pads, default=1)) if same_keys else None
    opt_s = time.perf_counter() - t0
    want = np.array(want)

    def lm_gate(fits):
        return lm_agreement(groups, fits, want, opt)

    agree = lm_gate(np.array(got)) if same_keys else dict(ok=False)
    checks["databases within the LM contract"] = same_keys and agree["ok"]
    if same_keys:
        flat = np.nonzero(agree["rel"] > CURVE_RTOL)[0]
        ratios = [np.sum((exp_model(groups[i][0], *got[i]) - groups[i][1])
                         ** 2) / np.sum((exp_model(groups[i][0], *want[i])
                                         - groups[i][1]) ** 2)
                  for i in flat]
        print(f"[11] databases, card against CPU: {agree['n']} groups, "
              f"{agree['converged']} converged (the CPU's curve within "
              f"{CONVERGED_RTOL} of the float64 optimum, "
              f"{opt_s:.1f} s on the host), worst converged gap "
              f"{agree['worst_converged']!r} (limit {CURVE_RTOL}); "
              f"beyond {CURVE_RTOL}: {agree['beyond']} (limit under "
              f"{BEYOND_SHARE * agree['n']:.1f}), worst "
              f"{agree['worst']!r} (limit {UNCONVERGED_RTOL}); "
              f"their sums of squares card / CPU "
              f"{min(ratios, default=1.0):.4f} to "
              f"{max(ratios, default=1.0):.4f} (card lower at "
              f"{sum(r < 1 for r in ratios)})")
        # controls: the same comparison must refuse a wrong LM on the card
        for name, wrong in (("bf16", dict(dtype=torch.bfloat16)),
                            ("20 steps", dict(iters=20))):
            bad = np.zeros_like(want)
            for pad in sorted(set(pads)):
                idx = [i for i, q in enumerate(pads) if q == pad]
                bad[idx] = fit_exponential_groups(
                    [groups[i] for i in idx], pad_to=pad, device=device,
                    **wrong)
            a = lm_gate(bad)
            conv, rel = a["is_converged"], a["rel"]
            checks[f"control: LM in {name} refused"] = not a["ok"]
            print(f"[11] control, the card's LM in {name}: refused "
                  f"{not a['ok']}; converged groups beyond "
                  f"{CURVE_RTOL}: "
                  f"{int((rel[conv] > CURVE_RTOL).sum())}, others "
                  f"beyond {UNCONVERGED_RTOL}: "
                  f"{int((rel[~conv] > UNCONVERGED_RTOL).sum())}"
                  f", beyond {CURVE_RTOL} in all {a['beyond']}, "
                  f"worst {a['worst']!r}")
    return checks


def registry_phase(smi, card_rows):
    """Phase 11: Alg 4 on ``suite``'s 33 combinations and the card's five,
    fitted on the card (one batched fit) and on the CPU; the card held to
    the CPU and to the launches the batched design makes; then the card's
    five combinations' uncertainty fits, their estimates and transfer to
    hardware they were not measured on.  Returns (ok, {kernel: launches})."""
    from repro_torch.bench.datasets import load_or_make
    from repro_torch.core.annealing import median_ape
    from repro_torch.core.fit import _pow2
    from repro_torch.core.predictor import train_param_predictors
    from repro_torch.core.registry import ModelRegistry
    data = load_or_make("suite").concat(card_rows)
    _zero_k4()
    t0 = time.perf_counter()
    card = ModelRegistry().fit(data)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    k4 = _read_k4()
    launches = {k: k4[k] for k in ("gbt_hist", "gbt_split", "gbt_grow")}
    t0 = time.perf_counter()
    cpu = ModelRegistry(device="cpu").fit(data)
    cpu_s = time.perf_counter() - t0
    keys = card._active_keys
    classes = set()
    for combo in card.combos:
        ii, oo, _, _ = _rows_of(data, keys, combo).workload
        _, counts = np.unique(np.stack([ii, oo], 1), axis=0,
                              return_counts=True)
        classes.add(_pow2(int(counts.max())))
    n_live = sum(cm.predictor is not None for cm in card.combos.values())
    want_levels = 150 * 5      # train_param_predictor's 150 trees, depth 4
    checks = {f"launches: one grow_forests of {want_levels} levels for "
              f"{n_live} combinations x 3 outputs in one gbt_grow launch, "
              f"one LM solve a padding class ({len(classes)})": (
                  k4["fits"] == 1 and _one_launch_a_fit(k4)
                  and k4["levels"] == want_levels
                  and k4["solves"] == len(classes))}
    print(f"[11] registry fit on {len(data)} rows, {len(card.combos)} "
          f"combinations ({n_live} with a predictor): card {card_s:.3f} s, "
          f"CPU {cpu_s:.3f} s; card launches gbt_grow {k4['gbt_grow']}, "
          f"gbt_hist {k4['gbt_hist']}, gbt_split {k4['gbt_split']}, fits "
          f"{k4['fits']} of {k4['levels']} levels on the card, levels by the "
          f"host loop {k4['host_levels']}; LM solves {k4['solves']} (padding "
          f"classes {sorted(classes)}) [{smi}]")
    checks.update(lm_checks(data, keys, card, cpu))
    # Alg 3 on the card from the CPU's databases: K4's trees
    trainings = [cm.db.training if cm.predictor is not None else None
                 for cm in cpu.combos.values()]
    got = train_param_predictors(trainings)
    want = train_param_predictors(trainings, device="cpu", use_kernel=True)
    checks["Alg 3 trees = plain K4's"] = all(
        (a is None) == (b is None) and (a is None or _same_trees(a, b))
        for a, b in zip(got, want))
    pc, pp = card.predict(data), cpu.predict(data)
    m_card, m_cpu = median_ape(data["thpt"], pc), median_ape(data["thpt"], pp)
    checks["medAPE"] = abs(m_card - m_cpu) <= ALA_TOL["medape"]
    print(f"[11] medAPE on all rows: card {m_card!r}, CPU {m_cpu!r} "
          f"(tolerance {ALA_TOL['medape']}); max relative prediction "
          f"difference {float(np.max(np.abs(pc - pp) / pp))!r}")
    # Alg 6-8 on the card's five combinations, default SAConfig
    t0 = time.perf_counter()
    card.fit_uncertainty(card_rows)
    unc_s = time.perf_counter() - t0
    err, d, conf = card.estimate(card_rows)
    fitted = [c for c, cm in card.combos.items() if cm.ala is not None]
    checks["estimates finite, confidence > 0"] = (
        len(fitted) == 5 and bool(np.all(np.isfinite(err)))
        and bool(np.all(conf > 0)) and bool(np.all(np.isfinite(d))))
    print(f"[11] fit_uncertainty on the card's {len(fitted)} combinations: "
          f"{unc_s:.1f} s; native estimates: error {float(err.min()):.3f} "
          f"to {float(err.max()):.3f}%, confidence {float(conf.min()):.4f} "
          f"to {float(conf.max()):.4f} [{smi}]")
    hi = keys.index("acc")
    for acc in ("gpu-a100-80g", "tpu-v4"):
        moved = _relabel(card_rows, acc)
        donors = {c: card.donor_for(c[:hi] + (acc,) + c[hi + 1:])
                  for c in fitted}
        e2, d2, c2 = card.estimate(moved, transfer=True)
        good = (all(d == c for c, d in donors.items())
                and bool(np.all(np.isfinite(e2))) and bool(np.all(c2 > 0))
                and bool(np.all(c2 < conf)) and np.allclose(d2, d, rtol=1e-7))
        checks[f"transfer to {acc}"] = good
        print(f"[11] transfer to {acc}: donors the card's own "
              f"combinations: {all(d == c for c, d in donors.items())}; "
              f"confidence {float(c2.min()):.4f} to {float(c2.max()):.4f}, "
              f"below native at every row: {bool(np.all(c2 < conf))}; d_min "
              f"the native one: {np.allclose(d2, d, rtol=1e-7)}")
    e3, d3, c3 = card.estimate(_relabel(card_rows, "gpu-unregistered"),
                               transfer=True)
    checks["unregistered hardware keeps the sentinel"] = bool(
        np.all(np.isnan(e3)) and np.all(np.isinf(d3)) and np.all(c3 == 0))
    print("[11] checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                      for k, v in checks.items()))
    return all(checks.values()), launches


def online_phase(smi, by_arch):
    """Phase 12: ``OnlineALA`` on the card ingests the five models' rows in
    two deltas (every cell's rep 0, then rep 1); after each, its
    predictions bit for bit a fresh card registry's on ``full_data()``;
    the gate quarantines a NaN row and an exact duplicate injected into the
    second delta.  Returns (ok, {kernel: launches})."""
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.online import OnlineALA, OnlineConfig
    from repro_torch.core.registry import ModelRegistry
    deltas = []
    for rep in range(MEASURE_GRID["reps"]):
        part = None
        for rows in by_arch.values():
            sub = rows[rep::MEASURE_GRID["reps"]]
            part = sub if part is None else part.concat(sub)
        deltas.append(part)
    row = {k: v[0].item() if isinstance(v[0], np.generic) else v[0]
           for k, v in deltas[1].cols.items()}
    bad = [dict(row, thpt=float("nan")), dict(row)]   # NaN, duplicate
    deltas[1] = deltas[1].concat(Dataset.from_rows(bad, require_finite=None))
    online = OnlineALA(OnlineConfig(
        sa=SAConfig(n_iters=ONLINE_SA["n_iters"]),
        warm_iters=ONLINE_SA["warm_iters"], gate=True))
    checks, launches = {}, {"gbt_hist": 0, "gbt_split": 0, "gbt_grow": 0}
    for i, delta in enumerate(deltas):
        _zero_k4()
        t0 = time.perf_counter()
        rep = online.ingest(delta)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4 = _read_k4()
        for k in launches:
            launches[k] += k4[k]
        checks[f"ingest {i + 1}: one gbt_grow launch a fit"] = (
            k4["fits"] > 0 and _one_launch_a_fit(k4))
        full = online.full_data()
        fresh = ModelRegistry().fit(full)
        same = np.array_equal(online.predict(full), fresh.predict(full))
        checks[f"ingest {i + 1}: predict bit-equal to a fresh fit"] = same
        print(f"[12] ingest {i + 1}: {rep.n_rows} rows, {len(rep.changed)} "
              f"combinations changed, {len(rep.refit)} refitted, "
              f"{rep.n_quarantined} quarantined; registry {rep.registry_s:.3f}"
              f" s, uncertainty {rep.uncertainty_s:.3f} s, wall {wall:.3f} s; "
              f"{k4['fits']} fits, K4 launches gbt_grow {k4['gbt_grow']}, "
              f"gbt_hist {k4['gbt_hist']}, gbt_split {k4['gbt_split']}; "
              f"predictions bit-equal to a fresh card registry on "
              f"{len(full)} rows: {same} [{smi}]")
    reasons = sorted(q.reason for q in online.quarantine)
    checks["gate: the NaN row and the duplicate"] =         reasons == ["duplicate", "nonfinite"]
    err, _, conf = online.estimate(online.full_data())
    checks["estimates finite"] = bool(np.all(np.isfinite(err))
                                      and np.all(conf > 0))
    print(f"[12] quarantined {reasons}; SA budgets n_iters "
          f"{ONLINE_SA['n_iters']}, warm_iters {ONLINE_SA['warm_iters']}; "
          f"checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                  for k, v in checks.items()))
    return all(checks.values()), launches


def baselines_phase(smi, ala_medape):
    """Phase 13: the Fig 7 baselines on ``inhouse`` 70/30 (seed 0) on the
    card and on the CPU; the card's held-out medAPE within ALA_TOL of the
    CPU's, its GBT baselines' and random forest's trees equal to the host
    loop's over K4's plain histograms; each GBT one gbt_grow launch, the
    random forest (which samples columns) K4's histograms a level.
    Returns (ok, {kernel: launches})."""
    from repro_torch.bench.datasets import make_inhouse_dataset, train_test_split
    from repro_torch.core.annealing import median_ape
    from repro_torch.core.baselines import _stack, make_baselines
    train, test = (d.workload for d in
                   train_test_split(make_inhouse_dataset(), 0.3))
    checks, launches = {}, {"gbt_hist": 0, "gbt_split": 0, "gbt_grow": 0}
    card, cpu = make_baselines(), make_baselines("cpu")
    for name in card:
        _zero_k4()
        t0 = time.perf_counter()
        card[name].fit(*train)
        got = card[name].predict(*test[:3])
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        k4 = _read_k4()
        for k in launches:
            launches[k] += k4[k]
        t0 = time.perf_counter()
        want = cpu[name].fit(*train).predict(*test[:3])
        cpu_s = time.perf_counter() - t0
        m_card, m_cpu = median_ape(test[3], got), median_ape(test[3], want)
        checks[f"{name} medAPE"] = abs(m_card - m_cpu) <= ALA_TOL["medape"]
        trees = ""
        model = card[name].model
        if name != "linear_regression":
            host = cpu[name].factory()
            if hasattr(host, "kw"):
                host.kw["use_kernel"] = True
            else:
                host.use_kernel = True
            host.fit(_stack(*train[:3]), train[3])
            members = getattr(model, "members_", [model])
            same = all(_same_trees(a, b) for a, b in zip(
                members, getattr(host, "members_", [host])))
            checks[f"{name} trees = plain K4's"] = same
            if hasattr(model, "members_"):    # K4's histograms a level
                checks[f"{name}: the host loop over K4's histograms"] = (
                    k4["gbt_hist"] == k4["host_levels"] > 0
                    and k4["gbt_split"] == k4["gbt_grow"] == k4["fits"] == 0)
            else:
                checks[f"{name}: one gbt_grow launch"] = (
                    k4["fits"] == 1 and _one_launch_a_fit(k4))
            trees = (f"; fits on the card {k4['fits']} ({k4['levels']} "
                     f"levels), K4 launches gbt_grow {k4['gbt_grow']}, "
                     f"gbt_hist {k4['gbt_hist']}, gbt_split {k4['gbt_split']}"
                     f", levels by the host loop {k4['host_levels']}; trees "
                     f"equal to the host loop's over K4's plain histograms: "
                     f"{same}")
        print(f"[13] {name}: held-out medAPE card {m_card!r}, CPU {m_cpu!r} "
              f"(ALA {ala_medape!r}); fit + predict card {card_s:.3f} s, CPU "
              f"{cpu_s:.3f} s{trees} [{smi}]")
    print("[13] checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                      for k, v in checks.items()))
    return all(checks.values()), launches


def _fleet_trace(horizon_s, seed):
    """benchmarks/run.py's fleet_engine workload: chat (Poisson 30/s,
    diurnal amplitude 0.4), summarize (Gamma 8/s, cv 2) and generate
    (MMPP 12/24 per s, two x3 flash crowds of 15 s)."""
    from repro_torch.serving.traces import (FleetTraceConfig, TenantConfig,
                                            TraceConfig, make_fleet_trace,
                                            mix)
    return make_fleet_trace(FleetTraceConfig(tenants=(
        TenantConfig(name="chat",
                     trace=TraceConfig(arrival="poisson", rate=30.0,
                                       shape_mix=mix(("chat", 1.0))),
                     ttft_slo_s=1.5, diurnal_amp=0.4),
        TenantConfig(name="summarize",
                     trace=TraceConfig(arrival="gamma", rate=8.0, cv=2.0,
                                       shape_mix=mix(("summarize", 1.0))),
                     ttft_slo_s=8.0),
        TenantConfig(name="generate",
                     trace=TraceConfig(arrival="mmpp", rate=12.0,
                                       burst_rate=24.0,
                                       shape_mix=mix(("generate", 1.0))),
                     ttft_slo_s=4.0, flash_crowds=2, flash_mult=3.0,
                     flash_dur_s=15.0),
    ), horizon_s=horizon_s, seed=seed))


def _engine_parity(heap, fleet):
    """The reference's parity rule between the heap and the fleet engine
    (``PARITY``).  Returns (ok, what it read)."""
    hv = {r.rid: r for r in heap.records}
    ttft, e2e, tpot, same_shed = [], [], [], True
    for r in fleet.records:
        h = hv[r.rid]
        same_shed = same_shed and h.shed == r.shed
        if h.first_token_s is not None and r.first_token_s is not None:
            ttft.append(abs(r.first_token_s - h.first_token_s))
        if h.done_s is not None and r.done_s is not None:
            e2e.append(abs(r.done_s - h.done_s))
            if h.oo > 1:
                tpot.append(abs((r.done_s - r.first_token_s) / (r.oo - 1)
                                - (h.done_s - h.first_token_s) / (h.oo - 1)))
    ok = (same_shed and heap.accounting() == fleet.accounting()
          and len(hv) == len(fleet.records))
    parts = []
    for name, d in (("TTFT", ttft), ("E2E", e2e)):
        d = np.asarray(d)
        p95, beyond = float(np.percentile(d, 95)), float(
            np.mean(d > PARITY["p95_s"]))
        ok = ok and (p95 <= PARITY["p95_s"] and d.max() <= PARITY["outlier_s"]
                     and beyond <= PARITY["outlier_frac"])
        parts.append(f"|{name}| p50 {np.percentile(d, 50):.4f} s, p95 "
                     f"{p95:.4f} s (limit {PARITY['p95_s']}), max "
                     f"{d.max():.4f} s (limit {PARITY['outlier_s']}), beyond "
                     f"the p95 limit {100 * beyond:.2f}% (limit "
                     f"{100 * PARITY['outlier_frac']:.0f}%)")
    tp95 = float(np.percentile(tpot, 95))
    ok = ok and tp95 <= PARITY["tpot_s"]
    parts.append(f"|TPOT| p95 {tp95:.5f} s (limit {PARITY['tpot_s']})")
    return ok, "; ".join(parts)


def gated(budget, label, fn):
    """Runs ``fn()`` under ``assert_max_compiles(budget, label)``: returns
    its result, the block's ``CompileReport`` and whether the block stayed
    within the budget (a breach is printed, not raised, so that the other
    phases still run)."""
    from repro_torch.staticcheck.tracers import (CompileBudgetExceeded,
                                                 assert_max_compiles)
    out = None
    try:
        with assert_max_compiles(budget, label=label) as report:
            out = fn()
    except CompileBudgetExceeded as err:
        print(err)
        return out, report, False
    return out, report, True


def online_loop(smi, device=None):
    """Phase 16 (d): benchmarks/run.py's online_engine closed loop at its
    full size, the port's OnlineALA on ``device`` (None: the card): each
    epoch serves one model's slice of its MMPP trace through the heap
    engine with an ALAAutoscaler attached to the engine, adapts the
    steady-state windows and ingests them, each ingest under the
    reference's compile budget (``benchmarks/run.py``'s online_engine: the
    first ingested epoch's count + 2), and passes both predictions through
    ``nan_guard``.  Returns (ok, K4 launches)."""
    from repro_torch.configs import get_config
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.online import OnlineALA, OnlineConfig
    from repro_torch.core.registry import ModelRegistry
    from repro_torch.perfmodel.hardware import TPU_V5E, feature_row
    from repro_torch.perfmodel.simulator import (ServingSetup,
                                                 sample_throughput,
                                                 throughput)
    from repro_torch.serving.adapter import TRACE_BACKEND, windows_to_dataset
    from repro_torch.serving.autoscaler import ALAAutoscaler
    from repro_torch.serving.simulator import SimConfig, simulate
    from repro_torch.serving.traces import TraceConfig, make_trace, mix
    from repro_torch.staticcheck.tracers import count_compiles, nan_guard
    archs, n_epochs = ONLINE_LOOP["archs"], ONLINE_LOOP["n_epochs"]
    epoch_s = ONLINE_LOOP["epoch_s"]
    ref_ii, ref_oo = 512, 192
    grid = [(ii, oo, bb) for ii in (128, 256, 512, 1024, 2048)
            for oo in (64, 128, 256, 512)
            for bb in (1, 2, 4, 8, 16, 32, 64, 128)]
    sa = SAConfig(n_iters=20, n_chains=2, seed=0,
                  gbt_kw=dict(n_estimators=20, learning_rate=0.2,
                              max_depth=3))
    gbt_kw = dict(n_estimators=20, learning_rate=0.15)
    eng = OnlineALA(OnlineConfig(sa=sa, warm_iters=6,
                                 gbt_kw=dict(sa.gbt_kw)), device=device)
    setups, traces, scalers, seed_rows = {}, {}, {}, []
    for arch in archs:
        cfg = get_config(arch)
        chips = 8 if cfg.param_count() > 1e10 else 4
        setups[arch] = ServingSetup(cfg=cfg, hw=TPU_V5E, chips=chips)
        rng = np.random.default_rng(0)
        seed_rows += [dict(model=arch, acc=TPU_V5E.name, acc_count=chips,
                           back=TRACE_BACKEND, prec="bf16", mode="serve",
                           ii=ii, oo=oo, bb=bb, thpt=float(t),
                           **feature_row(TPU_V5E))
                      for ii, oo, bb in grid
                      for t in sample_throughput(setups[arch], ii, oo, bb,
                                                 2, rng)]
        cap = throughput(setups[arch], ref_ii, ref_oo, 64) / ref_oo
        traces[arch] = make_trace(TraceConfig(
            arrival="mmpp", rate=0.7 * cap, burst_rate=2.0 * cap,
            horizon_s=n_epochs * epoch_s,
            shape_mix=mix(("chat", 0.7), ("generate", 0.3)), seed=29))
    checks = {"conservation": True, "compile budget": True}
    _zero_k4()
    t0 = time.perf_counter()
    with count_compiles("[16] (d) epoch 0") as cr:
        rep = eng.ingest(Dataset.from_rows(seed_rows), **gbt_kw)
    print(f"[16] (d) epoch 0: {rep.n_rows} calibration rows, "
          f"{len(rep.refit)} refits, ingest {time.perf_counter() - t0:.3f} s "
          f"(registry {rep.registry_s:.3f} s, uncertainty "
          f"{rep.uncertainty_s:.3f} s), {cr.count} compilations [{smi}]")
    for arch in archs:
        combo = eng.combo_of(next(r for r in seed_rows if r["model"] == arch))
        scalers[arch] = ALAAutoscaler(ala=eng.ala_for(combo), online=eng,
                                      combo=combo, max_replicas=4)
    n_epochs_ingested = 0
    budget, epoch_compiles = None, []
    for e in range(n_epochs):
        arch = archs[e % len(archs)]
        tr = traces[arch].slice(e * epoch_s, (e + 1) * epoch_s)
        t0 = time.perf_counter()
        res = simulate(tr, SimConfig(setup=setups[arch], batch_cap=64,
                                     n_replicas=1, max_replicas=4,
                                     t_start=e * epoch_s), scalers[arch])
        sim_s = time.perf_counter() - t0
        try:
            res.check_conservation()
        except RuntimeError as err:
            checks["conservation"] = False
            print(f"[16] (d) epoch {e + 1}: {err}")
        try:
            delta = windows_to_dataset(res, setups[arch], arch,
                                       window_s=epoch_s / 8.0)
        except ValueError:
            print(f"[16] (d) epoch {e + 1}: {arch}, {len(tr)} requests, no "
                  f"steady-state window")
            continue
        # the reference's gate: the first ingested epoch sets the budget,
        # its compile count + 2
        t0 = time.perf_counter()
        rep, cr, within = gated(budget, f"[16] (d) online epoch {e + 1}",
                                lambda: eng.ingest(delta, **gbt_kw))
        ingest_s = time.perf_counter() - t0
        checks["compile budget"] = checks["compile budget"] and within
        epoch_compiles.append(cr.count)
        if budget is None:
            budget = cr.count + 2
        n_epochs_ingested += 1
        drifted = {c[0]: d.drifted for c, d in rep.drift.items()}
        print(f"[16] (d) epoch {e + 1}: {arch}, {len(tr)} requests "
              f"{res.accounting()}, {len(res.controls)} control ticks, "
              f"replicas {sorted({a.n_replicas for _, a in res.controls})}; "
              f"simulated in {sim_s:.3f} s; {rep.n_rows} rows ingested in "
              f"{ingest_s:.3f} s (registry {rep.registry_s:.3f} s, "
              f"uncertainty {rep.uncertainty_s:.3f} s), refits "
              f"{[c[0] for c in rep.refit]}, drift flags {drifted}, "
              f"recalibration requests so far "
              f"{sum(len(s.recalibrations) for s in scalers.values())}")
    k4 = _read_k4()
    launches = {k: k4[k] for k in ("gbt_hist", "gbt_split", "gbt_grow")}
    checks["every refit one gbt_grow launch a fit"] = (
        k4["fits"] > 0 and _one_launch_a_fit(k4)) if device is None else True
    checks["epochs ingested"] = n_epochs_ingested == n_epochs
    full = eng.full_data()
    t0 = time.perf_counter()
    scratch = ModelRegistry(device=device).fit(full, **gbt_kw)
    scratch_s = time.perf_counter() - t0
    try:
        p_inc = nan_guard(eng.predict, label="online.predict")(full)
        p_scr = nan_guard(scratch.predict, label="scratch.predict")(full)
        checks["nan_guard on both predictions"] = True
    except FloatingPointError as err:
        print(f"[16] (d) {err}")
        checks["nan_guard on both predictions"] = False
        p_inc, p_scr = eng.predict(full), scratch.predict(full)
    parity = float(np.abs(p_inc - p_scr).max())
    checks[f"incremental = from-scratch fit within {ONLINE_LOOP['parity']}"] \
        = bool(np.all(np.isfinite(p_inc))) and parity <= ONLINE_LOOP["parity"]
    print(f"[16] (d) {len(full)} rows in all; K4 launches gbt_grow "
          f"{k4['gbt_grow']} for {k4['fits']} fits on the card ({k4['levels']}"
          f" levels), gbt_hist {k4['gbt_hist']}, gbt_split {k4['gbt_split']}"
          f", host levels {k4['host_levels']}, LM solves {k4['solves']}; "
          f"predictions against a from-scratch registry fit ({scratch_s:.3f}"
          f" s): max abs difference {parity!r}; compilations an ingested "
          f"epoch {epoch_compiles} (budget {budget} after the first); "
          f"checks: "
          + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in
                      checks.items()))
    return all(checks.values()), launches


def serving_phase(smi, llama_rows, device=None):
    """Phase 16: the port's serving stack.  (a) the three datasets made
    anew, bit for bit the cache; (b) the fleet_engine scenario, the numpy
    trajectories and then the torch ones on ``device`` (None: the card),
    equal; (c) the heap engine on its first 60 s against the fleet engine,
    the reference's parity rule; (d) ``online_loop``; (e) printed: the
    simulator's H100 profile beside phase [8]'s measured rows.  Returns
    (ok, {kernel: launches})."""
    from repro_torch.bench import datasets
    from repro_torch.configs import get_config
    from repro_torch.core.dataset import Dataset
    from repro_torch.perfmodel.hardware import H100_SXM, TPU_V5E
    from repro_torch.perfmodel.simulator import ServingSetup, throughput
    from repro_torch.serving.fleet import VectorFleetSimulator
    from repro_torch.serving.simulator import SimConfig, simulate
    checks = {}
    # (a) the datasets
    for name, make in (("inhouse", datasets.make_inhouse_dataset),
                       ("suite", datasets.make_suite_dataset),
                       ("mismatch", datasets.make_mismatch_dataset)):
        t0 = time.perf_counter()
        made = make()
        made_s = time.perf_counter() - t0
        cache = Dataset.load(datasets.DATA_DIR / name)
        same = len(made) == len(cache) and all(
            made[k].dtype == cache[k].dtype
            and made[k].tobytes() == cache[k].tobytes() for k in cache.cols)
        checks[f"(a) {name} = results/data/{name}.npz"] = same
        print(f"[16] (a) {name}: {len(made)} rows made anew in {made_s:.3f} s"
              f" on the host; bit for bit the cache in its "
              f"{len(cache.cols)} columns (thpt included): {same}")
    # (b) the fleet engine, numpy trajectories against torch on the card
    t0 = time.perf_counter()
    tr = _fleet_trace(FLEET["horizon_s"], FLEET["seed"])
    print(f"[16] (b) fleet_engine trace: {len(tr)} requests over "
          f"{FLEET['horizon_s']:.0f} s, made in {time.perf_counter() - t0:.3f}"
          f" s")
    setup = ServingSetup(cfg=get_config(ARCH), hw=TPU_V5E, chips=4)
    base = dict(setup=setup, batch_cap=FLEET["batch_cap"],
                n_replicas=FLEET["n_replicas"],
                max_replicas=FLEET["n_replicas"], bucket_s=FLEET["bucket_s"])
    runs, walls = {}, {}
    for backend in ("numpy", "torch"):
        sim = VectorFleetSimulator(tr, SimConfig(traj_backend=backend,
                                                 device=device, **base))
        # the reference's gate on its fleet_engine rerun: nothing compiles
        t0 = time.perf_counter()
        res, cr, checks[f"(b) {backend} run compiles nothing"] = gated(
            0, f"[16] (b) fleet_engine, {backend} trajectories", sim.run)
        wall = walls[backend] = time.perf_counter() - t0
        runs[backend] = res
        print(f"[16] (b) {backend} trajectories: {cr.count} compilations, "
              f"{wall:.3f} s wall, "
              f"{res.n_events} events ({res.n_events / wall:.0f} a second), "
              f"{sim.traj_calls} trajectory calls of "
              f"{sim.traj_steps / max(sim.traj_calls, 1):.1f} steps on "
              f"average, {res.accounting()}, sim_end_s {res.sim_end_s!r} "
              f"[{smi}]")
    a, b = runs["numpy"], runs["torch"]
    try:
        a.check_conservation()
        b.check_conservation()
        conserved = True
    except RuntimeError:
        conserved = False
    same = (conserved and a.accounting() == b.accounting()
            and a.n_events == b.n_events and a.sim_end_s == b.sim_end_s
            and all(a.req[k].tobytes() == b.req[k].tobytes()
                    for k in ("first_token_s", "done_s", "replica")))
    checks["(b) torch = numpy, accounting, events, per-request times bit "
           "for bit"] = same
    print(f"[16] (b) the card's trajectories against numpy's: accounting, "
          f"n_events, sim_end_s equal and done_s, first_token_s bit for bit: "
          f"{same}; torch / numpy wall {walls['torch'] / walls['numpy']:.2f}x")
    if device is None:
        # where a call's time goes: 100 calls at the run's mean length
        from repro_torch.serving.fleet import _TorchTraj
        k = round(sim.traj_steps / max(sim.traj_calls, 1))
        traj, bb = _TorchTraj(setup, device), np.full(k, 32.0)

        def calls():
            for _ in range(100):
                traj(bb, bb * 700.0)

        wall, busy, top, host, _ = _device_profile(calls, warm=True)
        print(f"[16] (b) 100 trajectory calls of {k} steps traced: "
              f"{wall / 100:.4f} ms a call, the device busy "
              f"{busy / 100:.4f} ms of it ({100 * busy / wall:.1f}%), "
              f"{sum(n for _, n, _ in top) / 100:.0f} device kernels and "
              f"copies a call: "
              + "; ".join(f"{name[:40]} x{n} {ms:.3f} ms"
                          for name, n, ms in top[:4])
              + "; host ops (self CPU): "
              + "; ".join(f"{name[:30]} x{n} {ms:.3f} ms"
                          for name, n, ms in host[:5]) + f" [{smi}]")
    # (c) the heap engine on the first 60 s against the fleet engine
    part = tr.slice(0.0, HEAP_SLICE_S)
    cfg = SimConfig(**base)
    t0 = time.perf_counter()
    heap = simulate(part, cfg, engine="heap")
    heap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fleet = simulate(part, cfg, engine="fleet")
    fleet_s = time.perf_counter() - t0
    ok_c, text = _engine_parity(heap, fleet)
    checks["(c) heap against fleet by the reference's parity rule"] = ok_c
    print(f"[16] (c) the first {HEAP_SLICE_S:.0f} s, {len(part)} requests: "
          f"heap {heap_s:.3f} s ({heap.n_events} events, "
          f"{heap.n_events / heap_s:.0f} a second), fleet {fleet_s:.3f} s "
          f"({fleet.n_events} events); {text}: {'ok' if ok_c else 'FAIL'}")
    # (d) the closed loop
    t0 = time.perf_counter()
    ok_d, launches = online_loop(smi, device)
    checks["(d) closed loop"] = ok_d
    print(f"[16] (d) closed loop: {time.perf_counter() - t0:.1f} s")
    # (e) the simulator's H100 profile beside the card's rows
    h100 = ServingSetup(cfg=get_config(ARCH), hw=H100_SXM, chips=1)
    ii, oo, bb, thpt = llama_rows.workload
    ratios = []
    for cell in sorted({(int(x), int(y), int(z)) for x, y, z in
                        zip(ii, oo, bb)}):
        at = (ii == cell[0]) & (oo == cell[1]) & (bb == cell[2])
        measured = float(np.mean(thpt[at]))
        predicted = throughput(h100, *cell)
        ratios.append(measured / predicted)
        print(f"[16] (e) {ARCH} (ii, oo, bb) = {cell}: the card "
              f"{measured:.1f} tok/s, the simulator's {H100_SXM.name} "
              f"profile {predicted:.1f}, card / profile {ratios[-1]:.3f}")
    print(f"[16] (e) card / profile {min(ratios):.3f} to {max(ratios):.3f} "
          f"(median {float(np.median(ratios)):.3f}) [{smi}]")
    print("[16] checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                      for k, v in checks.items()))
    return all(checks.values()), launches


def _same_spans(a, b) -> bool:
    """Two SpanTables equal in every column bit for bit (the object
    columns by value), with the same sampling bookkeeping."""
    from repro_torch.obs.tracing import SpanTable
    for f in dataclasses.fields(SpanTable):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(y, np.ndarray):
            if x.dtype != y.dtype or x.shape != y.shape or not (
                    x.tolist() == y.tolist() if y.dtype == object
                    else x.tobytes() == y.tobytes()):
                return False
        elif x != y:
            return False
    return True


def _same_steps(a, b) -> bool:
    return (a.steps_dropped == b.steps_dropped
            and a.step_totals == b.step_totals
            and list(a.step_arrays) == list(b.step_arrays)
            and all(a.step_arrays[k].tobytes() == b.step_arrays[k].tobytes()
                    for k in b.step_arrays))


def calibration_loop(smi, device=None):
    """Phase 17 (f): obs_engine's calibration audit at its full size, the
    port's OnlineALA on ``device`` (None: the card) and an ALAAutoscaler
    feeding one CalibrationAudit.  The seed grid is the roofline
    simulator's throughput derated to ``OBS_CAL["derate"]``, so early
    ticks are wrong at whatever confidence Alg 8 reports; each epoch's
    windows are adapted and ingested.  Returns (ok, audit, K4 counts)."""
    from repro_torch.configs import get_config
    from repro_torch.core.annealing import SAConfig
    from repro_torch.core.dataset import Dataset
    from repro_torch.core.online import OnlineALA, OnlineConfig
    from repro_torch.obs import CalibrationAudit, ObsConfig
    from repro_torch.perfmodel.hardware import TPU_V5E, feature_row
    from repro_torch.perfmodel.simulator import (ServingSetup,
                                                 sample_throughput,
                                                 throughput)
    from repro_torch.serving.adapter import (TRACE_BACKEND,
                                             summarize_windows,
                                             windows_to_rows)
    from repro_torch.serving.autoscaler import ALAAutoscaler
    from repro_torch.serving.simulator import SimConfig, simulate
    from repro_torch.serving.traces import TraceConfig, make_trace, mix
    n_epochs, epoch_s = OBS_CAL["n_epochs"], OBS_CAL["epoch_s"]
    setup = ServingSetup(cfg=get_config(ARCH), hw=TPU_V5E, chips=4)
    cap_req_s = throughput(setup, 512, 192, 64) / 192
    cal_tr = make_trace(TraceConfig(
        arrival="mmpp", rate=1.2 * cap_req_s, burst_rate=2.5 * cap_req_s,
        horizon_s=n_epochs * epoch_s,
        shape_mix=mix(("chat", 0.7), ("generate", 0.3)), seed=43))
    grid = [(ii, oo, bb) for ii in (128, 256, 512, 1024, 2048)
            for oo in (64, 128, 256) for bb in (1, 4, 16, 64)]
    sa = SAConfig(n_iters=12, n_chains=2, seed=0,
                  gbt_kw=dict(n_estimators=20, learning_rate=0.2,
                              max_depth=3))
    gbt_kw = dict(n_estimators=20, learning_rate=0.15)
    rng = np.random.default_rng(0)
    seed_rows = [dict(model=ARCH, acc=TPU_V5E.name, acc_count=4,
                      back=TRACE_BACKEND, prec="bf16", mode="serve",
                      ii=ii, oo=oo, bb=bb, thpt=OBS_CAL["derate"] * float(t),
                      **feature_row(TPU_V5E))
                 for ii, oo, bb in grid
                 for t in sample_throughput(setup, ii, oo, bb, 1, rng)]
    audit = CalibrationAudit(cfg=ObsConfig())
    eng = OnlineALA(OnlineConfig(sa=sa, warm_iters=5,
                                 gbt_kw=dict(sa.gbt_kw)), audit=audit,
                    device=device)
    _zero_k4()
    t0 = time.perf_counter()
    eng.ingest(Dataset.from_rows(seed_rows), **gbt_kw)
    combo = eng.combo_of(seed_rows[0])
    scaler = ALAAutoscaler(ala=eng.ala_for(combo), online=eng, combo=combo,
                           max_replicas=4, audit=audit, drift_window=4,
                           drift_ape_threshold=25.0)
    for e in range(n_epochs):
        etr = cal_tr.slice(e * epoch_s, (e + 1) * epoch_s)
        if not len(etr):
            continue
        res = simulate(etr, SimConfig(
            setup=setup, batch_cap=64, n_replicas=2, max_replicas=4,
            t_start=e * epoch_s, control_interval_s=1.0), scaler)
        rows = windows_to_rows(
            summarize_windows(res, window_s=epoch_s / 8.0), setup, ARCH)
        if rows:
            eng.ingest(Dataset.from_rows(rows), **gbt_kw)
    loop_s = time.perf_counter() - t0
    k4 = _read_k4()
    cal = audit.summary()
    acc = cal["reliability"]["bin_acc"]
    checks = {
        f"(f) >= {OBS['min_ticks']} ticks":
            cal["n_ticks"] >= OBS["min_ticks"],
        "(f) >= 1 refit event": audit.counts.get("refit", 0) >= 1,
        "(f) bin_acc monotone": len(acc) >= 1 and all(
            acc[i] <= acc[i + 1] + 1e-12 for i in range(len(acc) - 1)),
        "(f) one gbt_grow launch a fit": (k4["fits"] > 0
                                          and _one_launch_a_fit(k4))
        if device is None else True}
    print(f"[17] (f) calibration loop: {n_epochs} epochs of {epoch_s:.0f} s,"
          f" {len(seed_rows)} seed rows derated to {OBS_CAL['derate']}, "
          f"{loop_s:.1f} s; K4 launches gbt_grow {k4['gbt_grow']} for "
          f"{k4['fits']} fits on the card ({k4['levels']} levels), gbt_hist "
          f"{k4['gbt_hist']}, gbt_split {k4['gbt_split']}, host levels "
          f"{k4['host_levels']} [{smi}]")
    print(f"[17] (f) audit: events {cal['n_events']} (retained "
          f"{cal['n_events_retained']}), ticks {cal['n_ticks']}, accuracy "
          f"rate {cal['accuracy_rate']!r}, median APE {cal['median_ape']!r}, "
          f"median predicted error {cal['median_pred_err']!r}, "
          f"ape_over_pred_err {cal.get('ape_over_pred_err')!r}, median "
          f"confidence {cal['median_confidence']!r}, reliability "
          f"{cal['reliability']}; the reference's CPU record "
          f"(results/BENCH_obs.json): {OBS_REF['calibration']}")
    launches = {k: k4[k] for k in ("gbt_hist", "gbt_split", "gbt_grow")}
    return checks, audit, launches


def obs_phase(smi, device=None):
    """Phase 17: benchmarks/run.py's obs_engine at its full size through
    the port's obs layer.  (a) the fleet engine untraced and traced at
    sample rate 1 on the card's host, the span derivation's time against
    the untraced run's; (b) the traced run with ``traj_backend="torch"`` on ``device`` (None: the
    card), spans and capped step logs equal to numpy's; (c) heap against
    fleet spans over the first 60 s; (d) per-tenant TTFT shards merged;
    (e) the Chrome trace into ``chiprun_out/``; (f) ``calibration_loop``.
    Returns (ok, {kernel: launches})."""
    from repro_torch.configs import get_config
    from repro_torch.obs import (ObsConfig, StreamHist, percentile_with_inf,
                                 write_chrome_trace, write_jsonl)
    from repro_torch.obs.tracing import (queue_depth_series, record_spans,
                                         span_hists, span_stats)
    from repro_torch.perfmodel.hardware import TPU_V5E
    from repro_torch.perfmodel.simulator import ServingSetup
    from repro_torch.serving.simulator import SimConfig, simulate
    checks = {}
    tr = _fleet_trace(OBS["horizon_s"], OBS["seed"])
    setup = ServingSetup(cfg=get_config(ARCH), hw=TPU_V5E, chips=4)
    cfg = SimConfig(setup=setup, batch_cap=FLEET["batch_cap"],
                    n_replicas=FLEET["n_replicas"],
                    max_replicas=FLEET["n_replicas"],
                    bucket_s=FLEET["bucket_s"])
    cfg_obs = dataclasses.replace(cfg, obs=ObsConfig(sample_rate=1.0))

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        return out, time.perf_counter() - t0

    # (a) overhead.  Tracing adds nothing to the engine's loop: a traced
    # run is the untraced run (its results equal, checked here) plus
    # record_spans over the finished result.  The gate reads that
    # derivation's time against the untraced run's, the minimum of
    # OBS["runs"] each.  Whole traced and untraced runs are timed too, in
    # turns, and printed as the reference's reading: the difference of two
    # whole runs moves by more than the 5% gate between identical runs on
    # a shared host (PERF.md, §6).
    simulate(tr, cfg, engine="fleet")                   # warm-up
    base, traced = [], []
    for _ in range(OBS["runs"]):
        base.append(timed(simulate, tr, cfg, None, "fleet"))
        traced.append(timed(simulate, tr, cfg_obs, None, "fleet"))
    res_base, res_obs = base[0][0], traced[0][0]
    base_s, obs_s = min(s for _, s in base), min(s for _, s in traced)
    derive_s = min(timed(record_spans, res_base, cfg_obs.obs)[1]
                   for _ in range(OBS["runs"]))
    overhead = derive_s / base_s
    spans = res_obs.spans
    checks["(a) counts as the reference's record"] = (
        len(tr) == OBS_REF["n_requests"]
        and res_obs.n_events == OBS_REF["n_events"])
    checks["(a) spans cover every request"] = (
        spans is not None and spans.n == len(tr))
    checks["(a) traced run = untraced run + its spans"] = (
        res_base.spans is None
        and res_obs.n_events == res_base.n_events
        and all(res_obs.req[k].tobytes() == res_base.req[k].tobytes()
                for k in res_base.req if res_base.req[k].dtype != object)
        and _same_steps(res_obs, res_base)
        and _same_spans(record_spans(res_base, cfg_obs.obs), spans))
    checks[f"(a) overhead < {OBS['overhead']:.0%}"] = \
        overhead < OBS["overhead"]
    print(f"[17] (a) obs_engine fleet trace: {len(tr)} requests over "
          f"{OBS['horizon_s']:.0f} s, {res_obs.n_events} events (the "
          f"reference's record: {OBS_REF['n_requests']} and "
          f"{OBS_REF['n_events']}); untraced {base_s:.4f} s "
          f"({res_obs.n_events / base_s:.0f} events a second), spans "
          f"derived in {1e3 * derive_s:.3f} ms, minimum of {OBS['runs']} "
          f"each: "
          f"overhead {100 * overhead:.2f}% (gate "
          f"{100 * OBS['overhead']:.0f}%); whole runs in turns, untraced "
          f"{', '.join(f'{s:.4f}' for _, s in base)} s, traced at sample "
          f"rate 1 {', '.join(f'{s:.4f}' for _, s in traced)} s (minimum "
          f"{obs_s:.4f} s, {res_obs.n_events / obs_s:.0f} events a second, "
          f"{100 * (obs_s / base_s - 1.0):.2f}% over untraced); "
          f"{spans.n} spans [{smi}]")
    # (b) the card's trajectories: spans and capped step logs as numpy's
    t0 = time.perf_counter()
    res_t = simulate(tr, dataclasses.replace(cfg_obs, traj_backend="torch",
                                             device=device), engine="fleet")
    torch_s = time.perf_counter() - t0
    capped = {}
    for backend in ("numpy", "torch"):
        capped[backend] = simulate(tr, dataclasses.replace(
            cfg, traj_backend=backend, device=device,
            obs=ObsConfig(max_steps=OBS["max_steps"])), engine="fleet")
    a, b = capped["numpy"], capped["torch"]
    checks["(b) torch spans = numpy spans, every column"] = _same_spans(
        res_t.spans, spans)
    checks["(b) capped step logs equal"] = (
        _same_steps(a, b) and a.steps_dropped > 0
        and a.step_totals == res_obs.step_totals
        and len(a.step_arrays["t_end"]) == OBS["max_steps"])
    print(f"[17] (b) traj_backend=\"torch\" on the card, traced: {torch_s:.3f}"
          f" s, spans equal to numpy's in all columns: "
          f"{checks['(b) torch spans = numpy spans, every column']}; "
          f"max_steps {OBS['max_steps']}: steps dropped numpy "
          f"{a.steps_dropped}, torch {b.steps_dropped}, of "
          f"{a.step_totals['n']}; step_arrays, step_totals equal: "
          f"{checks['(b) capped step logs equal']}")
    # (c) heap against fleet spans on the first 60 s
    part = tr.slice(0.0, OBS["parity_s"])
    t0 = time.perf_counter()
    h = simulate(part, cfg_obs, engine="heap")
    heap_s = time.perf_counter() - t0
    f = simulate(part, cfg_obs, engine="fleet")
    sh, sf = span_stats(h.spans), span_stats(f.spans)
    tol50, tol95 = cfg.bucket_s + 0.35, cfg.bucket_s + 1.0
    ok_c = all(sh[k] == sf[k] for k in ("n_spans", "n_shed", "out_tokens"))
    gaps = {}
    for k, tol in (("ttft_p50_s", tol50), ("ttft_p95_s", tol95),
                   ("e2e_p50_s", tol50), ("e2e_p95_s", tol95)):
        gaps[k] = abs(sh[k] - sf[k])
        if np.isfinite(sh[k]) or np.isfinite(sf[k]):
            ok_c = ok_c and gaps[k] <= tol
    checks["(c) heap and fleet spans by the reference's rule"] = ok_c
    print(f"[17] (c) the first {OBS['parity_s']:.0f} s, {len(part)} "
          f"requests (heap {heap_s:.3f} s): n_spans {sh['n_spans']}/"
          f"{sf['n_spans']}, n_shed {sh['n_shed']}/{sf['n_shed']}, "
          f"out_tokens {sh['out_tokens']}/{sf['out_tokens']}; heap - fleet "
          + ", ".join(f"{k} {v:.4f} s" for k, v in gaps.items())
          + f" (limits {tol50} s at p50, {tol95} s at p95): "
          f"{'ok' if ok_c else 'FAIL'}")
    # (d) the per-tenant TTFT shards merged
    shards = span_hists(spans, n_bins=48, by=spans.tenant)
    merged = StreamHist.merged(shards.values())
    ttft = spans.ttft_s()
    exact_p95 = percentile_with_inf(ttft, 95.0)
    hist_p95 = merged.quantile(95.0)
    fin = ttft[np.isfinite(ttft)]
    bin_w = (fin.max() - fin.min()) / 46.0 if len(fin) else 0.0
    checks["(d) merged p95 within a bin"] = (
        not np.isfinite(exact_p95)
        or abs(hist_p95 - exact_p95) <= bin_w + 1e-9)
    qd = queue_depth_series(spans, bucket_s=cfg.bucket_s,
                            t_end=res_obs.sim_end_s)
    qd_hist = StreamHist.from_values(qd["depth"].astype(float), 32)
    print(f"[17] (d) {len(shards)} TTFT shards merged: p95 {hist_p95!r} "
          f"against {exact_p95!r} exact, bin width {bin_w!r}; queue depth "
          f"over {len(qd['t_s'])} buckets: p50 {qd_hist.quantile(50.0)!r}, "
          f"p95 {qd_hist.quantile(95.0)!r}, max {int(qd['depth'].max())}")
    # (e) the Chrome trace, into the gitignored chiprun_out/
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    path = write_chrome_trace(res_obs, out / "obs_trace_fleet.json",
                              max_step_events=OBS["max_step_events"],
                              max_span_events=OBS["max_span_events"])
    evs = json.loads(path.read_text())["traceEvents"]
    checks["(e) chrome trace well formed"] = bool(evs) and all(
        "ph" in e and "pid" in e for e in evs)
    print(f"[17] (e) {path.relative_to(REPO)}: {len(evs)} events (the "
          f"reference's record: {OBS_REF['trace_events']})")
    # (f) the calibration audit
    cal_checks, audit, launches = calibration_loop(smi, device)
    checks.update(cal_checks)
    n_ev = write_jsonl(audit.events, out / "obs_events.jsonl")
    print(f"[17] (f) {n_ev} audit events written to "
          f"chiprun_out/obs_events.jsonl")
    print("[17] checks: " + ", ".join(f"{k} {'ok' if v else 'FAIL'}"
                                      for k, v in checks.items()))
    return all(checks.values()), launches


# phase [18], training: qwen3-0.6b (examples/train_demo.py's default arch)
# whole, at the reference's train_4k sequence (configs/shapes.py), B 4,
# through Trainer.run with the reference trainer tests' AdamW settings;
# (b) and (d) at 2 layers, S 512, B 1
TRAIN_ARCH = "qwen3-0.6b"
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 4, 10
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
TRAIN_CUT = dict(n_layers=2, seq=512, batch=1)
# card against CPU in fp32: the loss (relative), each gradient and each
# updated parameter (the norm of the difference over the CPU's norm; one
# Adam step moves an element by about lr whatever its gradient, so an
# element whose gradient rounds to the other sign moves 2 lr apart, which
# only a norm tolerates); bf16's loss
TRAIN_TOL = dict(loss=1e-4, grad=1e-3, param=1e-4, bf16_loss=2e-2,
                 rtol=2e-4, atol=2e-5)
# K1's backward at the hidden norms' rows (B 4 x S 4,096 tokens, d 1,024)
# and qwen3's q/k norms' (16 heads of d 128 a token)
K1_BWD_SHAPES = ((16384, 1024), (16384 * 16, 128))
# K2's backward (B, Sq, Sk, H, KV, Dh, causal): qwen3's training shape,
# whisper's encoder (S 1,500, full) and its cross attention (Sq 512
# against Sk 1,500)
# the three kernels a call of K2's backward launches, once each
K2_BWD_KERNELS = ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")
K2_BWD_CASES = ((4, 4096, 4096, 16, 8, 128, True),
                (2, 1500, 1500, 16, 16, 64, False),
                (2, 512, 1500, 16, 16, 64, False))
# K2's bf16 backward against attention_bwd_bf16_emulated (most ulps, the
# share of elements beyond one): its ex2.approx and its fp32 sums' order
# flip the bf16 rounding of a few P or dS elements, each moving its sums by
# an ulp of that term, which a sum that cancels (dS sums to 0 over a row)
# can make several ulps of the result
K2_BWD_ULPS = (8, 1e-3)
# kernel kinds of a traced training step, by name (K1's backward first:
# its names hold "rmsnorm" too); the cross entropy and the optimizer are
# read from their profiler ranges
TRAIN_KINDS = (("K2 backward", ("fa_bwd",)), ("K2 forward", ("flash_fwd",)),
               ("K1 backward", ("rmsnorm_bwd",)), ("K1 forward", ("rmsnorm",)),
               ("GEMM", ("gemm", "nvjet", "xmma", "cutlass")))
TRAIN_RANGES = {"cross entropy": ("cross_entropy", "cross_entropy_bwd"),
                "optimizer": ("adamw_update",)}


def k1_bwd_checks(gen):
    """K1's backward, plain and fused, against its plain version on the
    card at K1_BWD_SHAPES in fp32 and bf16 (scale fp32, as the model holds
    it; one bf16 scale), and bit-equal over two runs."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                                 rmsnorm_bwd_ref)
    checks, same = Checks("rmsnorm_bwd"), []
    cases = [(rows, d, dt, fused, FP32) for rows, d in K1_BWD_SHAPES
             for dt in (FP32, BF16) for fused in (False, True)]
    cases.append((*K1_BWD_SHAPES[0], BF16, True, BF16))
    for rows, d, dt, fused, sdt in cases:
        x, dy = _randn(gen, (rows, d), dt), _randn(gen, (rows, d), dt)
        ds = _randn(gen, (rows, d), dt) if fused else None
        scale = (1 + 0.1 * _randn(gen, (d,), FP32)).to(sdt)
        got = rms_ops.rmsnorm_bwd(x, scale, dy, ds)
        want = (add_rmsnorm_bwd_ref(x, scale, dy, ds) if fused
                else rmsnorm_bwd_ref(x, scale, dy))
        case = (rows, d, "fused" if fused else "plain",
                str(sdt).replace("torch.", "scale "))
        checks.add(case + ("dx",), got[0], want[0], dt)
        checks.add_norm(case + ("dscale",), got[1], want[1], dt)
        again = rms_ops.rmsnorm_bwd(x, scale, dy, ds)
        same.append(all(torch.equal(_bits(a), _bits(b))
                        for a, b in zip(got, again)))
        del x, dy, ds, got, want, again
    return checks, same


def _plain_batch(b, h, sq, sk):
    """How many of ``b`` sequences the plain attention takes at once:
    all, unless their (Sq, Sk) fp32 scores pass 4.5 GB (it keeps about
    five such tensors)."""
    return b if b * h * sq * sk * 4 <= 4.5e9 else 1


def _bf16_ulps(got, want):
    """The gaps between two bf16 tensors in bf16 ulps of ``want`` (an ulp
    floored at that of 1/16, as ``test_torch_gpu.py``): the largest, and
    the share of elements more than one ulp apart."""
    if not want.numel():
        return 0.0, 0.0
    _, exp = torch.frexp(want.float().abs().clamp(min=1 / 16))
    ulp = torch.ldexp(torch.ones_like(want, dtype=torch.float32), exp - 8)
    gap = (got.float() - want.float()).abs() / ulp
    return gap.max().item(), (gap > 1).float().mean().item()


def k2_bwd_checks(gen):
    """K2's backward (dQ, dK, dV) against its plain version on the card at
    K2_BWD_CASES, fp32 and bf16, from the forward's own output and LSE;
    the LSE against the plain version's; two runs bit-equal; in bf16 the
    largest gap to ``attention_bwd_bf16_emulated`` in bf16 ulps and the
    share of elements beyond one, on the first sequence."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.emulate import \
        attention_bwd_bf16_emulated
    from repro_torch.kernels.flash_attention.ref import (attention_bwd_ref,
                                                         attention_ref)
    checks, lse_checks, same, ulps = (Checks("flash_attention_bwd"),
                                      Checks("flash_attention lse"), [], [])
    for b, sq, sk, h, kv, dh, causal in K2_BWD_CASES:
        pb = _plain_batch(b, h, sq, sk)
        for dt in (FP32, BF16):
            q = _randn(gen, (b, sq, h, dh), dt)
            k, v = (_randn(gen, (b, sk, kv, dh), dt) for _ in range(2))
            dout = _randn(gen, (b, sq, h, dh), dt)
            out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
            case = (b, sq, sk, h, kv, dh, "causal" if causal else "full")

            def hm(t):
                return t[:pb].transpose(1, 2)

            _, want_lse = attention_ref(hm(q), hm(k), hm(v), causal=causal,
                                        return_lse=True)
            lse_checks.add(case, lse[:pb], want_lse, dt)
            got = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                             causal=causal)
            want = attention_bwd_ref(hm(q), hm(k), hm(v), hm(out), hm(dout),
                                     causal=causal)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                checks.add(case + (name,), g[:pb], w.transpose(1, 2), dt)
            del want
            if dt == BF16:
                emu = attention_bwd_bf16_emulated(
                    *(t[:1] for t in (q, k, v, out, lse, dout)),
                    causal=causal)
                gaps = [_bf16_ulps(g[:1], e) for g, e in zip(got, emu)]
                ulps.append((case, max(m for m, _ in gaps),
                             max(f for _, f in gaps)))
                del emu
            again = fa_ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                               causal=causal)
            same.append(all(torch.equal(_bits(a), _bits(b))
                            for a, b in zip(got, again)))
            del q, k, v, dout, out, lse, got, again
            torch.cuda.empty_cache()
    return checks, lse_checks, same, ulps


def k1_bwd_timing(gen, rows, d, fused):
    """K1's backward (plain or fused) over ``rows`` x ``d`` bf16 rows, scale
    fp32, timed beside its plain version and ``F.rms_norm``'s backward by
    autograd (the library call); bound by the bytes it must move."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import (add_rmsnorm_bwd_ref,
                                                 rmsnorm_bwd_ref)
    nbytes = (4 if fused else 3) * rows * d * 2 + 2 * d * 4
    scale = torch.ones(d, device="cuda")
    sets = [(_randn(gen, (rows, d), BF16), scale,
             _randn(gen, (rows, d), BF16),
             _randn(gen, (rows, d), BF16) if fused else None)
            for _ in range(_n_sets(nbytes))]

    def plain(x, s, dy, ds):
        return (add_rmsnorm_bwd_ref(x, s, dy, ds) if fused
                else rmsnorm_bwd_ref(x, s, dy))

    lib_sets = []
    for x, _, dy, _ in sets:
        xr = x.detach().requires_grad_()
        w = scale.to(BF16).requires_grad_()
        y = torch.nn.functional.rms_norm(xr, (d,), w, 1e-5)
        lib_sets.append((y, xr, w, dy))

    def lib(y, xr, w, dy):
        return torch.autograd.grad(y, (xr, w), dy, retain_graph=True)

    x, s, dy, ds = sets[0]
    return dict(
        name="rmsnorm_bwd",
        shape=f"{rows}x{d} bf16 {'fused' if fused else 'plain'}",
        check=(rms_ops.rmsnorm_bwd(x, s, dy, ds)[0], plain(x, s, dy, ds)[0]),
        ms=time_ms(rms_ops.rmsnorm_bwd, sets),
        plain_ms=time_ms(plain, sets),
        library_ms=time_ms(lib, lib_sets),
        # two kernels a call (the rows, then the fixed-order sum of the
        # dscale partials), read by name: a count of calls over a trace
        # that lost records reads low (0.0115 ms against a 0.0401 ms
        # bound in one whole run)
        device_ms=2 * device_ms(rms_ops.rmsnorm_bwd, sets, "rmsnorm_bwd"),
        library_device_ms=device_ms(lib, lib_sets),
        library_call="F.rms_norm's backward (autograd)",
        bound=_bound(nbytes, rms_ops.rmsnorm_bwd_flops(rows, d), PEAK_FP32))


def k2_bwd_timing(gen, b, sq, sk, h, kv, dh, causal):
    """K2's backward at ``b`` sequences of ``sq`` query rows against ``sk``
    keys (bf16), timed beside its plain version and SDPA's backward by
    autograd (the library call).  The bound counts q, k, v, o, dO and lse
    read once, dq, dk, dv written once, and five products of the kept
    (row, key) pairs (QK^T again, dO V^T, P^T dO, dS K, dS^T Q) on the
    bf16 tensor cores."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref
    nbytes = 2 * (4 * b * sq * h * dh + 4 * b * sk * kv * dh) + 4 * b * h * sq
    sets = []
    for _ in range(_n_sets(nbytes)):
        q = _randn(gen, (b, sq, h, dh), BF16)
        k, v = (_randn(gen, (b, sk, kv, dh), BF16) for _ in range(2))
        out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
        sets.append((q, k, v, out, lse, _randn(gen, (b, sq, h, dh), BF16)))

    def kernel(q, k, v, out, lse, dout):
        return fa_ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                          causal=causal)

    def plain(q, k, v, out, lse, dout):
        return attention_bwd_ref(*(t.transpose(1, 2)
                                   for t in (q, k, v, out, dout)),
                                 causal=causal)

    lib_sets = []
    for q, k, v, _, _, dout in sets:
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        o = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
        lib_sets.append((o, qt, kt, vt, dout.transpose(1, 2)))

    def lib(o, qt, kt, vt, dot):
        return torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True)

    args = sets[0]
    rows = f"S{sq}" if sq == sk else f"Sq{sq} Sk{sk}"
    return dict(
        name="flash_attention_bwd",
        shape=(f"B{b} {rows} H{h} KV{kv} Dh{dh} bf16"
               + ("" if causal else " full")),
        check=(kernel(*args)[0], plain(*args)[0].transpose(1, 2)),
        ms=time_ms(kernel, sets, iters=8),
        plain_ms=time_ms(plain, sets, iters=2),
        library_ms=time_ms(lib, lib_sets, iters=8),
        device_ms=device_ms(kernel, sets, K2_BWD_KERNELS, calls=8),
        library_device_ms=device_ms(lib, lib_sets, calls=8),
        library_call="SDPA's backward (autograd)",
        bound=_bound(nbytes, fa_ops.flash_attention_bwd_flops(
            b, sq, sk, h, dh, causal, products=fa_ops.BWD_PRODUCTS_NEEDED),
            PEAK_BF16))


def _rel_norm(got, want) -> float:
    return ((got.float().cpu() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


def train_card_vs_cpu():
    """One ``Trainer`` step of qwen3-0.6b cut to TRAIN_CUT on the card
    against the CPU from the same parameters and batch: fp32 (loss, each
    gradient and each updated parameter by TRAIN_TOL) and bf16 (the loss;
    the gradients' gap printed).  Returns (ok, lines)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import AdamWConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, Trainer
    shape = ShapeSpec("train_cut", TRAIN_CUT["seq"], TRAIN_CUT["batch"],
                      "train")
    ok, lines = True, []
    for dt in (FP32, BF16):
        cfg = get_config(TRAIN_ARCH).scaled(n_layers=TRAIN_CUT["n_layers"],
                                            compute_dtype=dt)
        tc = TrainConfig(total_steps=1, opt=AdamWConfig(**TRAIN_OPT))
        cpu = Trainer(Model(cfg), shape, None, tc, device="cpu")
        card = Trainer(Model(cfg), shape, None, tc)
        params, opt = cpu.init_state(0)
        card.model.load({k: t.detach().to("cuda") for k, t in params.items()},
                        train=True)
        cparams = dict(card.model.named_parameters())
        t0 = time.perf_counter()
        _, _, loss_cpu, m_cpu = cpu.step(params, opt, cpu.batch(0))
        cpu_s = time.perf_counter() - t0
        _, _, loss_card, m_card = card.step(cparams, adamw_init(cparams),
                                            card.batch(0))
        loss_cpu, loss_card = float(loss_cpu), float(loss_card)
        loss_err = abs(loss_card - loss_cpu) / abs(loss_cpu)
        grad_err = max(_rel_norm(cparams[k].grad, p.grad)
                       for k, p in params.items())
        param_err = max(_rel_norm(cparams[k].detach(), p.detach())
                        for k, p in params.items())
        param_max = max((cparams[k].detach().cpu() - p.detach()).abs().max()
                        .item() for k, p in params.items())
        if dt == FP32:
            good = (loss_err <= TRAIN_TOL["loss"]
                    and grad_err <= TRAIN_TOL["grad"]
                    and param_err <= TRAIN_TOL["param"])
            want = (f"loss {TRAIN_TOL['loss']:g}, gradients "
                    f"{TRAIN_TOL['grad']:g}, parameters "
                    f"{TRAIN_TOL['param']:g}")
        else:
            good = loss_err <= TRAIN_TOL["bf16_loss"]
            want = f"loss {TRAIN_TOL['bf16_loss']:g}; the rest printed"
        ok = ok and good
        lines.append(
            f"[18] (b) {TRAIN_ARCH} at {TRAIN_CUT['n_layers']} layers, "
            f"{str(dt).replace('torch.', '')}, S {shape.seq_len} B "
            f"{shape.global_batch}, one Trainer step card against CPU: loss "
            f"{loss_card!r} / {loss_cpu!r} (rel {loss_err:.3g}), grad_norm "
            f"{float(m_card['grad_norm']):.6g} / "
            f"{float(m_cpu['grad_norm']):.6g}, worst gradient "
            f"{grad_err:.3g} of its norm, worst updated parameter "
            f"{param_err:.3g} of its norm (largest element gap "
            f"{param_max:.3g}); CPU step {cpu_s:.1f} s (tolerance {want}): "
            f"{'ok' if good else 'FAIL'}")
        del cpu, card, params, cparams, opt
        gc.collect()
        torch.cuda.empty_cache()
    return ok, lines


def train_restart_drill():
    """The reference's restart drill (tests/test_system.py) on the card at
    TRAIN_CUT: 6 steps uninterrupted against 3 steps, a fresh Trainer and
    3 more from the checkpoint.  Returns (ok, line)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.models.transformer import Model
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH).scaled(n_layers=TRAIN_CUT["n_layers"])
    shape = ShapeSpec("train_cut", TRAIN_CUT["seq"], TRAIN_CUT["batch"],
                      "train")
    opt = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        def make(name, total):
            return Trainer(Model(cfg), shape, None, TrainConfig(
                total_steps=total, ckpt_every=3 if name == "resume" else 6,
                ckpt_dir=f"{tmp}/{name}", log_every=10 ** 9, opt=opt))

        full = {k: t.detach().cpu() for k, t in
                make("full", 6).run(seed=3)[0].items()}
        make("resume", 3).run(seed=3)
        again = make("resume", 6)
        res = {k: t.detach().cpu() for k, t in again.run(seed=3)[0].items()}
    ok = (list(full) == list(res)
          and [h["step"] for h in again.history] == [3, 4, 5]
          and all(torch.allclose(full[k], res[k], rtol=TRAIN_TOL["rtol"],
                                 atol=TRAIN_TOL["atol"]) for k in full))
    gap = max((full[k] - res[k]).abs().max().item() for k in full)
    return ok, (f"[18] (d) restart drill at {TRAIN_CUT['n_layers']} layers: "
                f"6 steps against 3 + a fresh Trainer's 3 from the "
                f"checkpoint, largest parameter gap {gap:.3g} (rtol "
                f"{TRAIN_TOL['rtol']:g}, atol {TRAIN_TOL['atol']:g}), "
                f"{time.perf_counter() - t0:.1f} s: "
                f"{'ok' if ok else 'FAIL'}")


def _train_trace(step):
    """One traced call of ``step`` (after one untraced): wall ms, device
    busy ms, device ms by TRAIN_KINDS, by TRAIN_RANGES (the profiler
    ranges' device time, their kernels taken out of the other kinds) and
    the rest ("other elementwise"), and the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    for _ in range(3):   # again if the tracer saw no device work
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        events = prof.events()
        # the ranges also mark their spans on the device's timeline; those
        # spans are no device work
        ranges = {n for names in TRAIN_RANGES.values() for n in names}
        kernels = [e for e in events if e.device_type == DeviceType.CUDA
                   and e.name not in ranges]
        if kernels:
            break
    kinds = {k: 0.0 for k, _ in TRAIN_KINDS}
    rest, by_name = 0.0, {}
    for e in kernels:
        ms = e.device_time_total / 1e3
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + ms)
        kind = next((k for k, keys in TRAIN_KINDS
                     if any(key in e.name.lower() for key in keys)), None)
        if kind is None:
            rest += ms
        else:
            kinds[kind] += ms
    for kind, names in TRAIN_RANGES.items():
        kinds[kind] = sum(e.device_time_total for e in events
                          if e.device_type == DeviceType.CPU
                          and e.name in names) / 1e3
        rest -= kinds[kind]
    kinds["other elementwise"] = rest
    busy = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(((k, n, t) for k, (n, t) in by_name.items()),
                 key=lambda r: -r[2])
    return wall, busy, kinds, top


def train_whole(smi):
    """qwen3-0.6b whole (28 layers, full width) through ``Trainer.run`` at
    S TRAIN_SEQ, B TRAIN_BATCH, TRAIN_STEPS steps, launches counted
    exactly; then one step traced.  Returns (ok, launches, lines)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models.transformer import Model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k", TRAIN_SEQ, TRAIN_BATCH, "train")
    counters = (rms_ops.rmsnorm, rms_ops.add_rmsnorm, rms_ops.rmsnorm_bwd,
                fa_ops.flash_attention, fa_ops.flash_attention_bwd)
    plain, fused, n_attn = _step_counts(cfg, prefill=True)
    per_step = {"rmsnorm": plain, "add_rmsnorm": fused,
                "rmsnorm_bwd": plain + fused, "flash_attention": n_attn,
                "flash_attention_bwd": n_attn}
    saves = []
    orig_save = train_loop.ckpt.save_checkpoint

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = orig_save(*a, **kw)
        saves.append(time.perf_counter() - t0)
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(Model(cfg), shape, None, TrainConfig(
            total_steps=TRAIN_STEPS, ckpt_every=10 ** 9, ckpt_dir=tmp,
            log_every=10 ** 9, opt=AdamWConfig(**TRAIN_OPT)))
        for fn in counters:
            fn.launches = 0
        train_loop.ckpt.save_checkpoint = timed_save
        t0 = time.perf_counter()
        try:
            params, opt = trainer.run(seed=0)
        finally:
            train_loop.ckpt.save_checkpoint = orig_save
        run_s = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    want = {k: TRAIN_STEPS * n for k, n in per_step.items()}
    counts_ok = launches == want
    finite = all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                 for h in hist)
    falls = hist[-1]["loss"] < hist[0]["loss"]
    ok = counts_ok and finite and falls and len(hist) == TRAIN_STEPS
    n_params = sum(p.numel() for p in params.values())
    step_s = float(np.median([h["sec"] for h in hist[1:]]))
    tokens = TRAIN_SEQ * TRAIN_BATCH
    pairs = TRAIN_SEQ * (TRAIN_SEQ + 1) // 2
    attn_flops = (12 * cfg.d_head * pairs * TRAIN_BATCH * cfg.n_heads
                  * n_attn)
    flops = 6 * n_params * tokens + attn_flops
    lines.append(
        f"[18] (c) {TRAIN_ARCH} whole ({cfg.n_layers} layers, d "
        f"{cfg.d_model}, {n_params / 1e9:.3f} B parameters) through "
        f"Trainer.run, S {TRAIN_SEQ} B {TRAIN_BATCH}, {TRAIN_STEPS} steps "
        f"in {run_s:.1f} s: losses "
        + ", ".join(f"{h['loss']:.4f}" for h in hist)
        + "; grad_norm " + ", ".join(f"{h['grad_norm']:.3g}" for h in hist)
        + f"; finite {finite}, last below first {falls}: "
        f"{'ok' if finite and falls else 'FAIL'}")
    lines.append(
        f"[18] (c) step times " + ", ".join(f"{h['sec']:.3f}" for h in hist)
        + f" s; median after step 1 {1e3 * step_s:.1f} ms, "
        f"{tokens / step_s:.0f} tokens/s, {flops / step_s / 1e12:.1f} "
        f"TFLOP/s (6 N T = {6 * n_params * tokens / 1e12:.1f} TFLOP + "
        f"attention 12 Dh pairs B H L = {attn_flops / 1e12:.1f} TFLOP a "
        f"step), peak {peak:.2f} GB allocated, final checkpoint (params and "
        f"opt/) {sum(saves):.1f} s in {len(saves)} saves [{smi}]")
    lines.append(
        f"[18] (c) launches in {TRAIN_STEPS} steps: {launches}, expected "
        f"{want} (a step: {per_step}): {'ok' if counts_ok else 'FAIL'}")
    batch = trainer.batch(TRAIN_STEPS)
    state = {"p": params, "o": opt}

    def step():
        state["p"], state["o"], _, _ = trainer.step(state["p"], state["o"],
                                                    batch)

    wall, busy, kinds, top = _train_trace(step)
    lines.append(
        f"[18] (c) one traced step: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({100 * busy / wall:.1f}%); device ms by kind: "
        + ", ".join(f"{k} {v:.1f}" for k, v in kinds.items())
        + "; top kernels: "
        + "; ".join(f"{name[:48]} x{n} {ms:.1f} ms" for name, n, ms in top[:10])
        + f" [{smi}]")
    del trainer, params, opt, state, batch
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches, lines


def training_phase(smi):
    """Phase [18]: (a) the backward kernels against their plain versions
    and timed, (b) a 2-layer step card against CPU, (c) the whole model
    through Trainer.run, (d) the restart drill.  Returns (ok, main-path
    launches, timings for the JSON line)."""
    gen = torch.Generator("cuda").manual_seed(18)
    t0 = time.perf_counter()
    k1c, k1_same = k1_bwd_checks(gen)
    k2c, lse_c, k2_same, k2_ulps = k2_bwd_checks(gen)
    ok_a = all([c.report("[18] (a)") for c in (k1c, k2c, lse_c)])
    most, share = K2_BWD_ULPS
    ok_ulps = all(u <= most and f <= share for _, u, f in k2_ulps)
    print(f"[18] (a) flash_attention_bwd bf16 against its emulated rounding "
          f"points: " + ", ".join(f"{c[:3]} at most {u:.3g} ulp, {f:.2e} of "
                                  f"elements beyond 1" for c, u, f in k2_ulps)
          + f" (tolerance: {share:g} of the elements beyond one ulp, none "
          f"beyond {most}): " + ("ok" if ok_ulps else "FAIL"))
    ok_a = ok_a and all(k1_same) and all(k2_same) and ok_ulps
    print(f"[18] (a) two runs bit-equal: rmsnorm_bwd {sum(k1_same)} of "
          f"{len(k1_same)}, flash_attention_bwd {sum(k2_same)} of "
          f"{len(k2_same)} ({time.perf_counter() - t0:.1f} s): "
          f"{'ok' if all(k1_same) and all(k2_same) else 'FAIL'}")
    timings = [k1_bwd_timing(gen, *K1_BWD_SHAPES[0], fused=True),
               k1_bwd_timing(gen, *K1_BWD_SHAPES[0], fused=False),
               k1_bwd_timing(gen, *K1_BWD_SHAPES[1], fused=False),
               *(k2_bwd_timing(gen, *case) for case in K2_BWD_CASES)]
    for tm in timings:
        got, want = tm.pop("check")
        tm["err"] = _err(got, want)
        ok_a = ok_a and _close(got, want, BF16)
        print_timing("[18] (a)", tm, smi)
    torch.cuda.empty_cache()
    ok_b, lines = train_card_vs_cpu()
    print("\n".join(lines))
    ok_c, launches, lines = train_whole(smi)
    print("\n".join(lines))
    ok_d, line = train_restart_drill()
    print(line)
    ok = ok_a and ok_b and ok_c and ok_d
    print(f"[18] checks: (a) kernels {'ok' if ok_a else 'FAIL'}, (b) card "
          f"against CPU {'ok' if ok_b else 'FAIL'}, (c) whole model "
          f"{'ok' if ok_c else 'FAIL'}, (d) restart {'ok' if ok_d else 'FAIL'}"
          f" ({time.perf_counter() - t0:.1f} s)")
    return ok, launches, timings


# phase [19], the sharding policy path on a one-rank NCCL group: serving
# llama3.1-8b whole through the launch steps, training qwen3-0.6b whole
# under ZeRO-1, each bit for bit against the policy-free run
POLICY_PREFILL = (8, 512)            # B, S
POLICY_DECODE_STEPS = 8
POLICY_TRAIN = (4096, 4, 3)          # S, B, steps


def _kernel_counters():
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    return (rms_ops.rmsnorm, rms_ops.add_rmsnorm, rms_ops.rmsnorm_bwd,
            fa_ops.flash_attention, fa_ops.flash_attention_bwd,
            da_ops.decode_attention)


def _counted(fn):
    """(fn's result, the K1-K3 launches it made, its seconds), the card
    synchronised on both sides."""
    counters = _kernel_counters()
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    return out, {c.__name__: c.launches - b
                 for c, b in zip(counters, before)}, sec


def _whole(t):
    from repro_torch.distributed.compat import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _real_cost(fn, args):
    """One more call of ``fn`` (whose arguments are ``args``) on the card
    under ``launch/cost.py::StepCost``, for phase [21] (b): (the FLOPs of
    its local ops, its peak bytes: the arguments' storages plus the most
    it allocated beyond what was live before it).  Its launches are no
    phase's."""
    from repro_torch.launch.cost import StepCost
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cost = StepCost()
    held = cost.hold(args)
    with cost:
        fn()
    torch.cuda.synchronize()
    return dict(flops=cost.flops,
                peak=torch.cuda.max_memory_allocated() - before + held)


def policy_serve(mesh, smi):
    """llama3.1-8b whole in bf16: a prefill (B 8, S 512) and eager decode
    steps, policy-free and through ``build_prefill_step`` /
    ``build_serve_step`` under a serving policy (2D weights) on the (1, 1)
    mesh.  Returns (ok, launches of the policy calls, lines)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.compat import DTensor
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, sharded_step)
    from repro_torch.models.transformer import Model
    b, s = POLICY_PREFILL
    steps = POLICY_DECODE_STEPS
    cfg = get_config(ARCH)
    gen = torch.Generator("cuda").manual_seed(19)
    torch.cuda.reset_peak_memory_stats()
    model = Model(cfg).init(gen)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                         device="cuda")
    nxt = torch.randint(0, cfg.vocab_size, (steps, b, 1), generator=gen,
                        device="cuda")
    t_len = s + steps
    # policy-free: the prefill (timed at its second call, as the policy's),
    # then decode steps on a cache of t_len
    (lg0, _), free_pre, _ = _counted(lambda: model.prefill(toks, max_len=s))
    _, _, free_pre_s = _counted(lambda: model.prefill(toks, max_len=s))
    cache = model.init_cache(b, t_len)
    model.prefill(toks, cache=cache)
    spare = type(cache)(*cache)._replace(blocks=tuple(
        type(st)(*(t.clone() for t in st)) for st in cache.blocks),
        pos_t=cache.pos_t.clone())
    free_dec, free_steps = [], []
    for i in range(steps):
        (lg, cache), n, sec = _counted(
            lambda: model.decode_step(cache, nxt[i]))
        free_dec.append(lg)
        free_steps.append(sec)
    free_dec_n = n
    # the policy: every parameter placed by tree_shardings
    policy = ShardingPolicy(mesh, serving=True)
    pre, pre_in, pre_out, _ = build_prefill_step(
        model, policy, ShapeSpec("prefill", s, b, "prefill"))
    srv, srv_in, srv_out, _ = build_serve_step(
        model, policy, ShapeSpec("decode", t_len, b, "decode"))
    run_pre = sharded_step(policy, pre, pre_in, pre_out)
    run_srv = sharded_step(policy, srv, srv_in, srv_out)
    (lg1, cache1), pol_pre, _ = _counted(
        lambda: run_pre(dict(model.named_parameters()), {"tokens": toks}))
    params = dict(model.named_parameters())
    placed = all(isinstance(p, DTensor) and tuple(p.placements)
                 == pre_in[0][k].placements for k, p in params.items())
    same_pre = torch.equal(_whole(lg1), lg0)
    _, _, pol_pre_s = _counted(
        lambda: run_pre(params, {"tokens": toks}))
    dec_same, pol_steps = [], []
    state = {"cache": spare}
    for i in range(steps):
        (lg, state["cache"]), n, sec = _counted(
            lambda: run_srv(params, state["cache"], nxt[i]))
        dec_same.append(torch.equal(_whole(lg), free_dec[i]))
        pol_steps.append(sec)
    pol_dec_n = n
    peak = torch.cuda.max_memory_allocated() / 1e9
    real = _real_cost(lambda: run_pre(params, {"tokens": toks}),
                      (params, {"tokens": toks}))
    real["ms"] = 1e3 * pol_pre_s
    counts_ok = pol_pre == free_pre and pol_dec_n == free_dec_n and all(
        free_pre[k] > 0 for k in ("rmsnorm", "add_rmsnorm",
                                  "flash_attention")) and \
        free_dec_n["decode_attention"] > 0
    ok = same_pre and all(dec_same) and counts_ok and placed
    med = lambda xs: 1e3 * float(np.median(xs[1:]))
    lines = [
        f"[19] (a) {ARCH} whole, bf16, prefill B {b} S {s}: policy-free "
        f"{1e3 * free_pre_s:.1f} ms, through build_prefill_step "
        f"{1e3 * pol_pre_s:.1f} ms (second call); {steps} eager decode steps "
        f"from pos {s}: median after the first {med(free_steps):.2f} ms "
        f"policy-free, {med(pol_steps):.2f} ms through build_serve_step; "
        f"peak {peak:.2f} GB allocated [{smi}]",
        f"[19] (a) logits bit for bit: prefill {same_pre}, decode "
        f"{sum(dec_same)} of {steps}; every parameter a DTensor at "
        f"tree_shardings' placements: {placed}; launches a prefill "
        f"{pol_pre} (policy-free {free_pre}), a step {pol_dec_n} "
        f"(policy-free {free_dec_n}): {'ok' if ok else 'FAIL'}"]
    launches = {k: pol_pre.get(k, 0) + pol_dec_n.get(k, 0) for k in pol_pre}
    del model, params, cache, cache1, spare, state
    gc.collect()
    torch.cuda.empty_cache()
    return ok, launches, lines, real


def policy_train(mesh, smi):
    """qwen3-0.6b whole through ``Trainer.run`` (S 4,096, B 4, 3 steps),
    policy-free and under a ZeRO-1 policy on the (1, 1) mesh, from the
    same seed: losses and parameters bit for bit, launches equal.
    Returns (ok, launches of the policy run, lines, one more ZeRO-1 step's
    ``_real_cost`` and the run's step ms)."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.compat import DTensor
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.models.transformer import Model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_loop import TrainConfig, Trainer
    seq, batch, steps = POLICY_TRAIN
    cfg = get_config(TRAIN_ARCH)
    shape = ShapeSpec("train_4k", seq, batch, "train")
    runs = {}
    for name, policy in (("policy-free", None),
                         ("ZeRO-1", ShardingPolicy(mesh))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            trainer = Trainer(Model(cfg), shape, policy, TrainConfig(
                total_steps=steps, ckpt_every=10 ** 9, ckpt_dir=tmp,
                log_every=10 ** 9, opt=AdamWConfig(lr=1e-3, warmup_steps=2,
                                                   total_steps=steps)))
            save = train_loop.ckpt.save_checkpoint
            # the final 7 GB checkpoint is phase [18]'s; not written here
            train_loop.ckpt.save_checkpoint = lambda *a, **kw: None
            try:
                (params, opt), n, _ = _counted(lambda: trainer.run(seed=0))
            finally:
                train_loop.ckpt.save_checkpoint = save
        runs[name] = dict(
            loss=[h["loss"] for h in trainer.history],
            gnorm=[h["grad_norm"] for h in trainer.history],
            ms=1e3 * float(np.median([h["sec"] for h in
                                      trainer.history[1:]])),
            peak=torch.cuda.max_memory_allocated() / 1e9, launches=n,
            dtensor=all(isinstance(p, DTensor) for p in params.values()),
            zero=all(isinstance(m, DTensor) for m in opt.m.values()),
            params={k: _whole(p).detach().clone() for k, p in params.items()})
        if policy is not None:
            # one more step, counted, its gradients made anew as a step's
            for p in params.values():
                p.grad = None
            more = trainer.batch(steps)
            runs[name]["real"] = _real_cost(
                lambda: trainer.step(params, opt, more), (params, opt, more))
            del more
        del trainer, params, opt
        gc.collect()
    free, pol = runs["policy-free"], runs["ZeRO-1"]
    same_loss = free["loss"] == pol["loss"]
    differ = {k: float((free["params"][k] - pol["params"][k]).abs().max())
              for k in free["params"]
              if not torch.equal(free["params"][k], pol["params"][k])}
    same_params = not differ
    counts_ok = free["launches"] == pol["launches"] and all(
        pol["launches"][k] > 0 for k in ("rmsnorm", "add_rmsnorm",
                                          "rmsnorm_bwd", "flash_attention",
                                          "flash_attention_bwd"))
    ok = same_loss and same_params and counts_ok and pol["dtensor"] and \
        pol["zero"]
    lines = [
        f"[19] (b) {TRAIN_ARCH} whole, S {seq} B {batch}, {steps} steps: "
        f"step ms (median after the first) policy-free {free['ms']:.1f}, "
        f"ZeRO-1 policy {pol['ms']:.1f}; peak {free['peak']:.2f} and "
        f"{pol['peak']:.2f} GB allocated [{smi}]",
        f"[19] (b) losses {free['loss']} and {pol['loss']}: bit for bit "
        f"{same_loss}; grad norms {free['gnorm']} and {pol['gnorm']}; "
        f"parameters bit for bit {same_params}"
        + (f" ({len(differ)} differ, the most by "
           f"{max(differ.values()):.3g}: "
           f"{sorted(differ, key=differ.get)[-4:]})" if differ else "")
        + f"; parameters and "
        f"moments DTensors {pol['dtensor'] and pol['zero']}; launches "
        f"{pol['launches']} (policy-free {free['launches']}): "
        f"{'ok' if ok else 'FAIL'}"]
    real = dict(pol["real"], ms=pol["ms"])
    del runs
    gc.collect()
    torch.cuda.empty_cache()
    return ok, pol["launches"], lines, real


def policy_phase(smi):
    """Phase [19]: a one-rank NCCL group from a ``FileStore`` in a
    temporary directory (no TCP port), the (1, 1) ("data", "model") mesh,
    (a) serving and (b) training through the sharding policy, the group
    destroyed at the end.  Returns (ok, launches of the policy calls, the
    prefill's and the training step's ``_real_cost`` with their ms)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.distributed.compat import init_device_mesh
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(Path(tmp) / "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "model"))
            for c in _kernel_counters():
                c.launches = 0
            ok_a, grew_a, lines, real_pre = policy_serve(mesh, smi)
            print("\n".join(lines))
            ok_b, grew_b, lines, real_train = policy_train(mesh, smi)
            print("\n".join(lines))
        finally:
            dist.destroy_process_group()
    launches = {k: grew_a.get(k, 0) + grew_b.get(k, 0)
                for k in set(grew_a) | set(grew_b)}
    print(f"[19] checks: (a) serving {'ok' if ok_a else 'FAIL'}, (b) "
          f"training {'ok' if ok_b else 'FAIL'}; launches through the "
          f"policy {launches} ({time.perf_counter() - t0:.1f} s)")
    return ok_a and ok_b, launches, {"prefill": real_pre,
                                     "train": real_train}


# phase [21], the dry run: perf_report's three cells traced on the (16,
# 16) fake mesh (full, u1 and u2; auto and baseline policy) in a process
# of its own, and phase [19]'s two policy calls traced on a fake world of
# one rank, held to their real calls: FLOPs exactly, peak memory within
# DRYRUN_PEAK_TOL
DRYRUN_PEAK_TOL = 0.10
DRYRUN_FLAG = "--dryrun-phase"


def dryrun_child(path) -> int:
    """Phase [21]'s traces, run as ``chip_smoke.py --dryrun-phase PATH``:
    no card is touched.  Writes the records' summaries, the
    ``perf_report`` table, the two one-rank traces and the K1-K3 launch
    counters' growth (0 when every kernel ran as its shape-only op) to
    PATH as JSON."""
    from repro_torch.analysis import perf_report
    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import ShardingPolicy
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.transformer import Model
    t_start = time.perf_counter()
    counters = _kernel_counters()
    before = [c.launches for c in counters]
    recs = []
    for arch, shape, _ in perf_report.CELLS:
        for policy in ("auto", "baseline"):
            for u in (0, 1, 2):
                t0 = time.perf_counter()
                rec = dryrun.run_cell(arch, shape, unroll_periods=u,
                                      policy_mode=policy)
                recs.append({**{k: rec.get(k) for k in (
                    "arch", "shape", "policy", "unroll_periods", "status",
                    "error", "flops", "bytes_accessed", "memory",
                    "collectives")}, "s": time.perf_counter() - t0,
                    "file": dryrun.record_name(rec)})
    table = perf_report.report()
    b, s = POLICY_PREFILL
    seq, batch, _ = POLICY_TRAIN
    traced = {}
    with dryrun.fake_world(1):
        mesh = make_host_mesh(1, device_type="cuda")
        for name, arch, policy, shape in (
                ("prefill", ARCH, ShardingPolicy(mesh, serving=True),
                 ShapeSpec("prefill", s, b, "prefill")),
                ("train", TRAIN_ARCH, ShardingPolicy(mesh),
                 ShapeSpec("train_4k", seq, batch, "train"))):
            t0 = time.perf_counter()
            cost, mem = dryrun.trace_step(Model(get_config(arch)), policy,
                                          shape)
            traced[name] = dict(
                flops=cost.flops, bytes=cost.bytes_accessed, memory=mem,
                peak=mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"],
                s=time.perf_counter() - t0)
    Path(path).write_text(json.dumps(dict(
        records=recs, table=table, traced=traced,
        launches=[c.launches - n for c, n in zip(counters, before)],
        s=time.perf_counter() - t_start)))
    return 0


def dryrun_start():
    """Starts ``dryrun_child`` in a process of its own, which sees no card
    (``CUDA_VISIBLE_DEVICES`` empty) and runs beside the card's phases:
    one process cannot hold phase [19]'s NCCL group and a 256-rank fake
    group, and the traces need only the host.  Returns (the process, its
    directory); the process is killed at exit if it still runs."""
    import atexit
    import os
    import tempfile
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))
    with open(tmp / "log.txt", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), DRYRUN_FLAG,
             str(tmp / "dryrun.json")], stdout=log, stderr=subprocess.STDOUT,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, tmp


def staticcheck_phase() -> bool:
    """Phase [22]: the port's checker (``repro_torch.staticcheck``) over its
    package, this script and the port's tests must report nothing, and a
    seedless ``torch.randn`` planted in an in-memory source must give
    exactly one ``unseeded-rng`` finding (a checker that checks nothing
    fails).  Returns ok."""
    from repro_torch.staticcheck import check_paths, check_source
    paths = [REPO / "src" / "repro_torch", REPO / "chip_smoke.py",
             *sorted((REPO / "tests").glob("test_torch_*.py"))]
    t0 = time.perf_counter()
    res = check_paths(paths, root=REPO)
    secs = time.perf_counter() - t0
    for f in res.findings:
        print(f"[22]   {f.format()}")
    planted = [(f.rule, f.line) for f in check_source(
        "import torch\nx = torch.randn(4, 8)\n",
        "src/repro_torch/core/planted.py")]
    ok = res.ok and res.n_files > 100 and planted == [("unseeded-rng", 2)]
    print(f"[22] repro-torch-check on Python {sys.version.split()[0]}, torch "
          f"{torch.__version__}: {len(res.findings)} findings in "
          f"{res.n_files} files in {secs:.3f} s (host); a planted seedless "
          f"torch.randn gives {planted}: {'ok' if ok else 'FAIL'}")
    return ok


def dryrun_phase(smi, started, real, launches):
    """Phase [21]: waits for ``dryrun_start``'s process (``started``), then
    copies its records to ``chiprun_out/dryrun/``.  Gates: (a) every record
    ok; (b) each one-rank trace's FLOPs equal to ``real``'s (phase [19]'s
    calls, counted alike), its peak within DRYRUN_PEAK_TOL of the real
    one, and each call's measured ms at least its compute term; (c) the
    kernels' launch counters, and the ``kernels`` line's counts
    (``launches``), unchanged.  Returns ok."""
    import shutil
    from repro_torch.analysis.roofline import HBM_BW, PEAK_FLOPS
    t0 = time.perf_counter()
    counters = _kernel_counters()
    before = [c.launches for c in counters]
    counted = dict(launches)
    proc, tmp = started
    try:
        rc = proc.wait(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        rc = proc.wait()
    out = tmp / "dryrun.json"
    res = json.loads(out.read_text()) if out.exists() else None
    log = (tmp / "log.txt").read_text()
    shutil.rmtree(tmp, ignore_errors=True)
    if rc != 0 or res is None:
        print(f"[21] the dry run's process failed (rc {rc}):\n{log[-3000:]}")
        return False
    dst = REPO / "chiprun_out" / "dryrun"
    dst.mkdir(parents=True, exist_ok=True)
    from repro_torch.launch.dryrun import RESULTS
    for f in [*(RESULTS / r["file"] for r in res["records"]),
              RESULTS.parent / "perf_report.json"]:
        if f.exists():
            shutil.copy(f, dst / f.name)
    ok_a = all(r["status"] == "ok" for r in res["records"])
    for r in res["records"]:
        mem = r["memory"] or {}
        print(f"[21] (a) {r['arch']} {r['shape']} {r['policy']} "
              f"u{r['unroll_periods']}: {r['status']} in {r['s']:.1f} s; "
              f"{r['flops'] or 0:.4g} FLOP, {r['bytes_accessed'] or 0:.4g} "
              f"bytes, arguments "
              f"{mem.get('argument_size_in_bytes', 0) / 1e9:.2f} GB, temp "
              f"{mem.get('temp_size_in_bytes', 0) / 1e9:.2f} GB a device; "
              f"collectives {r['collectives']}"
              + (f"; {r['error']}" if r["error"] else ""))
    print("[21] (a) perf_report (per-device terms of one rank's traced "
          "step, H100 constants):\n" + res["table"])
    ok_b = True
    for name in ("prefill", "train"):
        tr, rl = res["traced"][name], real[name]
        t_comp = 1e3 * tr["flops"] / PEAK_FLOPS
        t_mem = 1e3 * tr["bytes"] / HBM_BW
        same = tr["flops"] == rl["flops"]
        close = abs(tr["peak"] - rl["peak"]) <= DRYRUN_PEAK_TOL * rl["peak"]
        slower = rl["ms"] >= t_comp
        ok_b = ok_b and same and close and slower
        print(f"[21] (b) {name} (phase [19]'s call) traced on one fake rank "
              f"in {tr['s']:.1f} s: {tr['flops']:.6g} FLOP traced, "
              f"{rl['flops']:.6g} counted over the real call: equal {same}; "
              f"peak {tr['peak'] / 1e9:.3f} GB traced, {rl['peak'] / 1e9:.3f} "
              f"GB real (arguments plus what the call allocated): within "
              f"{DRYRUN_PEAK_TOL:.0%} {close}; measured {rl['ms']:.2f} ms, "
              f"compute term {t_comp:.2f} ms ({rl['ms'] / t_comp:.2f}x), "
              f"memory term {t_mem:.2f} ms ({tr['bytes'] / 1e9:.2f} GB, "
              f"{rl['ms'] / t_mem:.2f}x; no gate) [{smi}]")
    ok_c = (res["launches"] == [0] * len(counters)
            and [c.launches for c in counters] == before
            and dict(launches) == counted)
    print(f"[21] (c) launches in the traces {res['launches']}, in this "
          f"process unchanged: {'ok' if ok_c else 'FAIL'}")
    ok = ok_a and ok_b and ok_c
    print(f"[21] checks: (a) records {'ok' if ok_a else 'FAIL'}, (b) one rank "
          f"against the real calls {'ok' if ok_b else 'FAIL'}, (c) launches "
          f"{'ok' if ok_c else 'FAIL'} (the traces took {res['s']:.1f} s "
          f"beside the card's phases; {time.perf_counter() - t0:.1f} s "
          f"waited here)")
    return ok


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; it runs only on a GPU",
              file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.inference.engine import ServingEngine
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import add_rmsnorm_ref, rmsnorm_ref
    from repro_torch.models.transformer import Model
    from repro_torch.staticcheck.tracers import count_compiles

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
    da_so = _build.load("decode_attention")
    for src in logs:
        for symbol, (regs, spill) in _build.ptxas_report(src).items():
            fn = _kernel_name(symbol)
            m = re.fullmatch(r"decode_attn_split<(fp32|bf16), (\d+)>", fn)
            smem = "" if not m else (
                f", {da_so.decode_attention_smem_bytes(m[1] == 'bf16', int(m[2]))}"
                f" B of dynamic shared memory a block")
            print(f"[2]   {src}: {fn}: {regs} registers, {spill} B spilled"
                  f"{smem}")
    # the tensor-core gate: every bf16 instantiation of K2 runs its
    # products on the tensor cores and spills no register
    fa_so = _build.load("flash_attention")
    mma = {_kernel_name(k): n for k, n in
           _build.tensor_core_counts("flash_attention").items()}
    fa_regs = {_kernel_name(k): r for k, r in
               _build.ptxas_report("flash_attention").items()}
    fwd16 = [k for k in mma if "bf16" in k]
    ok2 = len(fwd16) == len(_build.HEAD_DIMS) and all(
        mma[k] > 0 and fa_regs.get(k, (0, -1))[1] == 0 for k in fwd16)
    for k, n in sorted(mma.items()):
        dtype = 1 if "bf16" in k else 0
        dh = int(re.search(r"(\d+)>$", k)[1])
        regs, spill = fa_regs.get(k, ("?", "?"))
        print(f"[2]   flash_attention: {k}: {n} HMMA/HGMMA instructions, "
              f"{regs} registers at launch, {spill} B spilled, "
              f"{fa_so.flash_attention_threads(dtype)} threads and "
              f"{fa_so.flash_attention_smem_bytes(dtype, dh)} B of dynamic "
              f"shared memory a block")
    print(f"[2] tensor-core gate (HMMA/HGMMA and no spill in every bf16 "
          f"flash_attention kernel): {'ok' if ok2 else 'FAIL'}")
    # K2's backward: HGMMA (wgmma) in every bf16 dK/dV and dQ kernel, and
    # no register spilled there
    kinds = _build.tensor_core_kinds("flash_attention_bwd")
    report = _build.ptxas_report("flash_attention_bwd")
    bwd_so = _build.load("flash_attention_bwd")
    bwd = sorted((_kernel_name(k), n, report[k]) for k, n in kinds.items()
                 if "_bf16" in k)
    ok2_bwd = len(bwd) == 2 * len(_build.HEAD_DIMS) and all(
        n["HGMMA"] > 0 and regs[1] == 0 for _, n, regs in bwd)
    for k, n, (regs, spill) in bwd:
        dh = int(re.search(r"(\d+)>$", k)[1])
        print(f"[2]   flash_attention_bwd: {k}: {n['HGMMA']} HGMMA, "
              f"{n['HMMA']} HMMA instructions, {regs} registers at launch, "
              f"{spill} B spilled, "
              f"{bwd_so.flash_attention_bwd_smem_bytes(2, dh)} B of dynamic "
              f"shared memory a block")
    print(f"[2] backward gate (HGMMA and no spill in every bf16 dK/dV and dQ "
          f"kernel): {'ok' if ok2_bwd else 'FAIL'}")
    ok2 = ok2 and ok2_bwd
    # phase [21]'s traces need only the host: they run from here on, beside
    # the card's phases, and phase [21] reads them
    dry = dryrun_start()

    # -- 3. kernels against their plain versions ----------------------------
    gen = torch.Generator("cuda").manual_seed(0)
    rms_c, add_c, sums = Checks("rmsnorm"), Checks("add_rmsnorm"), []
    # the sweep of test_kernels.py, the main path's rows at d 4096, a row
    # that is not whole 16-byte vectors, the newer configs' widths (a
    # decode step's rows and a prefill's) and qwen3's q/k norms over rows
    # of one head; scale fp32 and bf16
    for shape in ((8, 64), (3, 5, 128), (1, 256), (17, 96), (8, 4096),
                  (32, 4096), (4096, 4096), (2, 33), QK_ROWS,
                  *((r, d) for d in WIDTHS_NEW + WIDTHS_BLOCKS
                    for r in (8, 2048))):
        for dt in (FP32, BF16):
            for sdt in (FP32, BF16):
                x, r = _randn(gen, shape, dt), _randn(gen, shape, dt)
                scale = _randn(gen, shape[-1:], sdt)
                rms_c.add(shape, rms_ops.rmsnorm(x, scale),
                          rmsnorm_ref(x, scale), dt)
                (s_got, y_got), (s_want, y_want) = (
                    rms_ops.add_rmsnorm(x, r, scale),
                    add_rmsnorm_ref(x, r, scale))
                add_c.add(shape, y_got, y_want, dt)
                sums.append(torch.equal(_bits(s_got), _bits(s_want)))
    fa_c = Checks("flash_attention")

    # the sweeps of test_kernels.py, the llama widths, the newer configs'
    # heads (16, 24, 40, 64 over 8) at S 128 and 512, and ragged S around
    # the 64-row tiles at every head size
    for b, h, kv, s, dh in ((1, 4, 4, 128, 64), (2, 8, 2, 256, 64),
                            (1, 4, 1, 128, 128), (2, 6, 2, 64, 32),
                            (1, 4, 2, 50, 16), (2, 32, 8, 512, 128),
                            (2, 32, 8, 1000, 128),
                            *((2, 8 * g, 8, s, 128) for g in GROUPS_NEW
                              for s in (128, 512)),
                            *((2, 8, 2, s, dh)
                              for s in (1, 63, 65, 127, 129, 1000)
                              for dh in _build.HEAD_DIMS)):
        for causal in (True, False):
            for dt in (FP32, BF16):
                q = _randn(gen, (b, s, h, dh), dt)
                k = _randn(gen, (b, s, kv, dh), dt)
                v = _randn(gen, (b, s, kv, dh), dt)
                fa_c.add((b, h, kv, s, dh, causal),
                         fa_ops.flash_attention(q, k, v, causal=causal),
                         _flash_want(q, k, v, causal), dt)
    # q, k, v as strided views into one buffer whose other rows, heads and
    # columns hold NaN: a read outside the views would reach the output
    for s in (65, 129):
        for dh in (64, 128):
            for causal in (True, False):
                for dt in (FP32, BF16):
                    buf = torch.full((2, s + 7, 14, dh + 16), math.nan,
                                     dtype=dt, device="cuda")
                    rows, cols = slice(3, 3 + s), slice(8, 8 + dh)
                    q, k, v = (buf[:, rows, 0:8, cols],
                               buf[:, rows, 9:11, cols],
                               buf[:, rows, 12:14, cols])
                    for x in (q, k, v):
                        x.copy_(_randn(gen, x.shape, dt))
                    fa_c.add(("strided, NaN around", s, dh, causal),
                             fa_ops.flash_attention(q, k, v, causal=causal),
                             _flash_want(q, k, v, causal), dt)
    da_c = Checks("decode_attention")
    decode_cases = [(2, 8, 2, 128, 64), (1, 4, 4, 512, 128),
                    (4, 16, 8, 256, 64), (3, 4, 2, 77, 16)]
    decode_cases += [(b, 32, 8, t, 128) for b in (1, 8, 64) for t in (576, 2080)]
    decode_cases += [(b, 8 * g, 8, 576, 128) for g in GROUPS_NEW for b in (1, 8)]
    for b, h, kv, t, dh in decode_cases:
        for frac in (0.1, 0.5, 1.0):
            for dt in (FP32, BF16):
                q = _randn(gen, (b, h, dh), dt)
                k = _randn(gen, (b, t, kv, dh), dt)
                v = _randn(gen, (b, t, kv, dh), dt)
                pos = int((t - 1) * frac)
                da_c.add((b, h, kv, t, dh, pos),
                         da_ops.decode_attention(q, k, v, pos),
                         _decode_want(q, k, v, pos), dt)
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
    da_exact = decode_split_checks(gen, da_c)
    da_exact.update(decode_graph_checks(gen))
    ok3 = all([c.report() for c in (rms_c, add_c, fa_c, da_c)])
    print(f"[3] add_rmsnorm: s bit for bit x + r in {sum(sums)} of "
          f"{len(sums)} cases: {'ok' if all(sums) else 'FAIL'}")
    print(f"[3] decode_attention across its splits: "
          + ", ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in da_exact.items()))
    ok3 = ok3 and all(da_exact.values()) and all(sums)
    rng = np.random.default_rng(0)
    ok_k4, k4_err, lines = k4_checks(rng)
    print("\n".join(lines))
    ok_split, line = split_checks()
    print(line)
    ok_grow, lines = grow_checks()
    print("\n".join(lines))
    ok_level, line = level_path_check(smi)
    print(line)
    ok3 = ok3 and ok_k4 and ok_split and ok_grow and ok_level

    # -- 4. timing at the main path's shapes --------------------------------
    cfg = get_config(ARCH)
    h, kv, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
    table, timings = {}, []
    # K1, plain and fused, over the prefill's rows (both cells: 4,096) and
    # one decode step's rows (8 and 32); scale fp32 as the model holds it;
    # then a prefill's rows at the newer configs' widths and qwen3's q/k
    # norms (one block a row of 128)
    rms_rows = sorted({r for ii, oo, bb in CELLS for r in (bb * ii, bb)},
                      reverse=True)
    for rows, dd in ((*((r, d) for r in rms_rows), QK_ROWS,
                      *((8192, w) for w in WIDTHS_NEW + WIDTHS_BLOCKS))):
        timings += k1_timings(gen, rows, dd)
    for dd in (QK_ROWS[1], *WIDTHS_NEW, *WIDTHS_BLOCKS):
        print(f"[4] K1 at d {dd} bf16: a prefill's rows "
              f"{k1_plan(8192, dd)}; a decode step's 8 rows "
              f"{k1_plan(8, dd)}")
    for ii, oo, bb in CELLS:
        # flash attention over the prompt, causal
        timings.append(k2_timing(gen, bb, ii, ii, h, kv, dh, True))
        # decode attention at the last step: the cache holds ii + oo - 1
        timings.append(k3_timing(gen, bb, ii + oo, h, kv, dh, smi,
                                 by_split=True))
    # K2 at qwen3-0.6b's training shape, keeping the rows' lse as the
    # training step's forward does
    timings.append(k2_timing(gen, *K2_BWD_CASES[0], lse=True))
    # K3 at the newer configs' groups, at the first cell's decode step
    ii, oo, bb = CELLS[0]
    timings += [k3_timing(gen, bb, ii + oo, 8 * g, 8, dh, smi)
                for g in GROUPS_NEW]
    timings += [k4_timing(rng, K4_MAIN), k4_timing(rng, K4_BIG),
                k4_timing(rng, K4_REG), split_timing()]
    from repro_torch.kernels.gbt_hist.cases import MAIN_FITS
    timings += [grow_timing(name) for name in MAIN_FITS]
    ok4 = True
    for tm in timings:
        got, want = tm.pop("check")
        tm["err"] = _err(got, want)
        ok4 = ok4 and {"gbt_hist": tm["err"] <= K4_TOL,
                       "gbt_split": tm["err"] == 0.0,
                       "gbt_grow": tm["err"] == 0.0}.get(
                           tm["name"], _close(got, want, BF16))
        print_timing("[4]", tm, smi)
        # the JSON line reports each kernel at the first cell's prefill
        # shape, and K4's at the ALA predictor's first shape (gbt_grow: a
        # whole Alg 3 fit)
        table.setdefault(tm["name"], tm)
    table["gbt_hist"]["err"] = max(table["gbt_hist"]["err"], k4_err)
    torch.cuda.empty_cache()

    # -- 5. 2-layer models at full width, card against CPU; graphed
    # against eager -------------------------------------------------------
    ok5 = True
    for arch in (ARCH, *DENSE_NEW):
        ok5 = model_checks("[5]", f"2-layer {arch}",
                           get_config(arch).scaled(n_layers=2)) and ok5
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
    counters = (rms_ops.rmsnorm, rms_ops.add_rmsnorm, fa_ops.flash_attention,
                da_ops.decode_attention)
    launches = {fn.__name__: 0 for fn in counters}
    replays = 0
    n_layers = cfg.n_layers
    for ii, oo, bb in CELLS:
        # the main path: the graphed engine, counters zeroed just before
        for fn in counters:
            fn.launches = 0
        engine.captures = engine.replays = 0
        with count_compiles(f"[6] measure_throughput {ii} {oo} {bb}") as cr:
            rows = engine.measure_throughput(ii, oo, bb, reps=REPS)
        prompts = np.random.default_rng(7).integers(
            0, cfg.vocab_size, (bb, ii), dtype=np.int32)
        # the same signature again: nothing may compile
        tokens, again, within = gated(
            0, f"[6] generate ii={ii} oo={oo} bb={bb}",
            lambda: engine.generate(prompts, oo).tokens)
        compiled_ok = within and cr.n_builds == 0 and cr.n_frames == 0
        grew = [fn.launches for fn in counters]
        for fn in counters:
            launches[fn.__name__] += fn.launches
        replays += engine.replays
        # prefills; steps run eagerly (one warm-up before each capture);
        # steps captured, which count once however often they replay
        pre, cap = 1 + REPS + 1, engine.captures
        expect = [pre + 2 * cap, 2 * n_layers * (pre + 2 * cap),
                  n_layers * pre, n_layers * 2 * cap]
        counts_ok = (grew == expect and cap == 1
                     and engine.replays == pre * (oo - 1))
        # the eager loop at the same cell, after the graphed runs
        eager = [eager_generate(model, np.random.default_rng(r).integers(
            0, cfg.vocab_size, (bb, ii), dtype=np.int32), oo)
            for r in range(1 + REPS)][1:]
        same = np.array_equal(eager_generate(model, prompts, oo)["tokens"],
                              tokens)
        ok6 = ok6 and counts_ok and same and compiled_ok and all(
            r["thpt"] > 0 and r["prefill_s"] > 0 and r["decode_s"] > 0
            for r in rows + eager)
        for what, rs in (("graphed", rows), ("eager", eager)):
            for r in rs:
                print(f"[6] {what} ii={ii} oo={oo} bb={bb}: thpt "
                      f"{r['thpt']:.1f} tok/s, prefill {r['prefill_s']:.4f} "
                      f"s, decode {r['decode_s']:.4f} s "
                      f"({1e3 * r['decode_s'] / (oo - 1):.2f} ms a step), "
                      f"peak memory "
                      f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
                      f"[{smi}]")
        print(f"[6] launches rmsnorm/add_rmsnorm/flash/decode: {grew}, "
              f"expected {expect} ({pre} prefills, {cap} capture(s), each "
              f"after one eager warm-up step); replays {engine.replays}, "
              f"expected {pre * (oo - 1)}; graphed tokens equal the eager "
              f"loop's: {same}: {'ok' if counts_ok and same else 'FAIL'}")
        print(f"[6] compile gates: measure_throughput captured "
              f"{cr.n_captures} graph(s), built {cr.n_builds} sources, "
              f"compiled {cr.n_frames} "
              f"frames; generate at the same signature compiled "
              f"{again.count} (budget 0): "
              f"{'ok' if compiled_ok else 'FAIL'}")
    print(f"[6] main path launches: {launches}, decode steps replayed "
          f"{replays}: {'ok' if ok6 else 'FAIL'}")

    # -- 7. where the time goes: one traced prefill, 8 eager decode steps
    # and 8 graph replays per cell (the tracer adds host time, so busy
    # shares read low) -----------------------------------------------------
    ok7 = True
    for ii, oo, bb in CELLS:
        prompts = torch.randint(0, cfg.vocab_size, (bb, ii), device="cuda",
                                generator=torch.Generator("cuda").manual_seed(3))
        graph = engine.decode_graph(bb, ii + oo)
        _, cache = model.prefill(prompts, ii + oo)
        model.prefill(prompts, cache=graph.cache)
        graph.start(prompts[:, -1:])

        def decode8(cache=cache, tok=prompts[:, -1:]):
            for _ in range(8):
                _, cache = model.decode_step(cache, tok)

        def replay8(graph=graph):
            for _ in range(8):
                graph.replay()

        for what, fn in ((f"prefill B{bb} S{ii}",
                          lambda: model.prefill(prompts, ii + oo)),
                         (f"8 eager decode steps B{bb} from pos {ii}",
                          decode8),
                         (f"8 graph replays B{bb} from pos {ii}", replay8)):
            wall, busy, top, host, _ = _device_profile(fn)
            kernels = "; ".join(f"{name[:48]} x{n} {ms:.3f} ms"
                                for name, n, ms in top[:6])
            ops = "; ".join(f"{name[:40]} x{n} {ms:.3f} ms"
                            for name, n, ms in host[:6])
            ours = {k: (sum(n for name, n, _ in top if k in name),
                        sum(ms for name, _, ms in top if k in name))
                    for k in ("rmsnorm", "flash_fwd", "decode_attn")}
            print(f"[7] {what}: wall {wall:.2f} ms, device busy {busy:.2f} "
                  f"ms ({100 * busy / wall:.1f}%); top kernels: {kernels}; "
                  f"the port's kernels: "
                  + "; ".join(f"{k} x{n} {ms:.3f} ms"
                              for k, (n, ms) in ours.items())
                  + f"; top host ops (self CPU): {ops} [{smi}]")
            if what.startswith("8 graph"):
                # the kernels of a replayed step, listed from the captured
                # graph itself; and those the tracer recorded in 8 more
                # replays, which may fall short of them (the tracer drops
                # a kernel record now and then, in eager traces too) but
                # never exceed them
                names = graph.kernel_names()
                keys = ("rmsnorm", "decode_attn")
                per_step = tuple(sum(k in n for n in names) for k in keys)
                want = (2 * n_layers + 1, n_layers)
                traced = _kernel_launches(replay8, keys)
                seen = all(0 < t <= 8 * w for t, w in zip(traced, want))
                ok7 = ok7 and per_step == want and seen
                print(f"[7] the same trace counts rmsnorm "
                      f"{ours['rmsnorm'][0]} and decode attention "
                      f"{ours['decode_attn'][0]} kernels in 8 replays")
                print(f"[7] kernels a replayed step, from the graph's "
                      f"{len(names)} kernel nodes: rmsnorm {per_step[0]}, "
                      f"decode attention {per_step[1]} (expected "
                      f"{want[0]}, {want[1]}): "
                      f"{'ok' if per_step == want else 'FAIL'}; traced in "
                      f"8 more replays by name: rmsnorm {traced[0]} of "
                      f"{8 * want[0]}, decode attention {traced[1]} of "
                      f"{8 * want[1]}: {'ok' if seen else 'FAIL'}")
        # the last fn is replay8, whose default holds the graph
        del graph, cache, decode8, replay8, fn

    # -- 8. serving rows as ALA input --------------------------------------
    from repro_torch.bench.harness import measure_arch
    from repro_torch.core.annealing import median_ape
    from repro_torch.core.database import build_exponential_database, db_predict
    t0 = time.perf_counter()
    rows = llama_rows = measure_arch(ARCH, model=model, **MEASURE_GRID)
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
    del model, engine, logits
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[8] {torch.cuda.memory_allocated() / 1e9:.2f} GB left allocated "
          f"after llama3.1-8b is freed")

    # -- 9. ALA on the card against the CPU ---------------------------------
    t0 = time.perf_counter()
    ok9, k4_launches, ala_medape = ala_phase(smi)
    launches.update(k4_launches)
    print(f"[9] ALA phase: {'ok' if ok9 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 10. the newer dense configs at full width and depth ---------------
    t0 = time.perf_counter()
    ok10, grew, by_arch = measure_phase(
        "[10]", smi, [(arch, get_config(arch)) for arch in DENSE_NEW])
    for k, n in grew.items():
        launches[k] += n
    by_arch = {ARCH: llama_rows, **by_arch}
    print(f"[10] full-depth phase: {'ok' if ok10 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 11. Alg 4 on the card; 12. online refit; 13. Fig 7 baselines -------
    card_rows = None
    for rows in by_arch.values():
        card_rows = rows if card_rows is None else card_rows.concat(rows)
    results = {}
    for tag, fn in (("[11] Alg 4", lambda: registry_phase(smi, card_rows)),
                    ("[12] online", lambda: online_phase(smi, by_arch)),
                    ("[13] baselines",
                     lambda: baselines_phase(smi, ala_medape))):
        t0 = time.perf_counter()
        good, grew = fn()
        for k, n in grew.items():
            launches[k] += n
        results[tag] = good
        print(f"{tag} phase: {'ok' if good else 'FAIL'} "
              f"({time.perf_counter() - t0:.1f} s)")

    # -- 14. MoE and recurrent blocks ----------------------------------------
    t0 = time.perf_counter()
    ok14, grew = blocks_phase(smi)
    for k, n in grew.items():
        launches[k] += n
    print(f"[14] MoE and recurrent blocks: {'ok' if ok14 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 15. whisper-medium's encoder-decoder path, internvl2-1b's vision
    # stub ---------------------------------------------------------------
    t0 = time.perf_counter()
    ok15, grew = encdec_phase(smi)
    for k, n in grew.items():
        launches[k] += n
    print(f"[15] encoder-decoder and vision: {'ok' if ok15 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 16. the serving stack: the datasets made anew, the fleet engine's
    # trajectories on the card, heap against fleet, the closed loop with
    # ALA in it -----------------------------------------------------------
    t0 = time.perf_counter()
    ok16, grew = serving_phase(smi, llama_rows)
    for k, n in grew.items():
        launches[k] += n
    print(f"[16] serving stack: {'ok' if ok16 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 17. the observability layer: spans, ring caps, heap against fleet,
    # merged histograms, the Chrome trace, the calibration audit -----------
    t0 = time.perf_counter()
    ok17, grew = obs_phase(smi)
    for k, n in grew.items():
        launches[k] += n
    print(f"[17] observability: {'ok' if ok17 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 18. training: the backward kernels, a 2-layer step card against
    # CPU, qwen3-0.6b whole through Trainer.run, the restart drill ----------
    t0 = time.perf_counter()
    ok18, grew, train_timings = training_phase(smi)
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n
    for tm in train_timings:
        table.setdefault(tm["name"], tm)
    print(f"[18] training: {'ok' if ok18 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 19. the sharding policy path: serving and training through the
    # launch steps on a one-rank mesh, bit for bit against the policy-free
    # calls ---------------------------------------------------------------
    t0 = time.perf_counter()
    ok19, grew, real = policy_phase(smi)
    for k, n in grew.items():
        launches[k] = launches.get(k, 0) + n
    print(f"[19] sharding policy: {'ok' if ok19 else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")

    # -- 22. the port's static checker on this machine's Python and torch ----
    ok22 = staticcheck_phase()

    # -- 21. the dry run: the policy's three cells traced on a 256-rank fake
    # mesh, and phase [19]'s calls traced on one fake rank against their
    # real counts ------------------------------------------------------------
    ok21 = dryrun_phase(smi, dry, real, launches)

    # -- 20. result -----------------------------------------------------------
    sources = {"rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                           "src/repro/kernels/rmsnorm/kernel.py:24"),
               "add_rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                               "src/repro/kernels/rmsnorm/kernel.py:24"),
               "flash_attention": ("cuda", "src/repro_torch/csrc/flash_attention.cu",
                                   "src/repro/kernels/flash_attention/kernel.py:76"),
               "decode_attention": ("cuda", "src/repro_torch/csrc/decode_attention.cu",
                                    "src/repro/kernels/decode_attention/kernel.py:67"),
               "gbt_hist": ("cuda", "src/repro_torch/csrc/gbt_hist.cu",
                            "src/repro/kernels/gbt_hist/kernel.py:49"),
               "gbt_split": ("cuda", "src/repro_torch/csrc/gbt_hist.cu",
                             "src/repro/core/gbt.py:608"),
               "gbt_grow": ("cuda", "src/repro_torch/csrc/gbt_hist.cu",
                            "src/repro/kernels/gbt_hist/kernel.py:49"),
               # the backward kernels replace no TPU kernel (the reference
               # differentiates the jnp twins): each names the TPU kernel
               # whose gradient it computes
               "rmsnorm_bwd": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                               "src/repro/kernels/rmsnorm/kernel.py:24"),
               "flash_attention_bwd": (
                   "cuda", "src/repro_torch/csrc/flash_attention_bwd.cu",
                   "src/repro/kernels/flash_attention/kernel.py:76")}
    # gbt_split runs only on the level path, for fits beyond a block's
    # shared memory; no main-path fit is one (phase [3] drives that path)
    off_main = {"gbt_split"}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        tm = table[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            main_path=name not in off_main,
            launches=launches[name], max_abs_err=tm["err"], ms=tm["ms"],
            plain_ms=tm["plain_ms"], bound_ms=tm["bound"][0],
            bound_by=tm["bound"][1], library_ms=tm["library_ms"],
            device_ms=tm["device_ms"],
            library_device_ms=tm["library_device_ms"], shape=tm["shape"],
            **{k: tm[k] for k in ("library_call", "two_call_ms",
                                  "copy_device_ms") if k in tm}))
    phases = {"[2] tensor-core gate": ok2, "[3] kernels": ok3,
              "[4] timing shapes": ok4, "[5] 2-layer": ok5,
              "[6] full width": ok6, "[7] traces": ok7,
              "[8] measure_arch": ok8, "[9] ALA": ok9,
              "[10] full depth": ok10, **results,
              "[14] MoE and recurrent blocks": ok14,
              "[15] encoder-decoder and vision": ok15,
              "[16] serving stack": ok16, "[17] observability": ok17,
              "[18] training": ok18, "[19] sharding policy": ok19,
              "[22] static checker": ok22, "[21] dry run": ok21,
              "[20] launches": all(
                  (k["launches"] > 0) == k["main_path"] for k in kernels)}
    ok = all(phases.values())
    print(f"[20] phases: " + ", ".join(f"{k} {v}" for k, v in phases.items())
          + f"; {time.perf_counter() - t_start:.0f} s in all")
    if not ok:
        failed = [name for name, good in phases.items() if not good]
        print(f"chip_smoke: FAILED: {', '.join(failed)}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [DRYRUN_FLAG]:
        sys.exit(dryrun_child(sys.argv[2]))
    sys.exit(main())
