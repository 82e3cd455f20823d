"""K2 (``flash_attention``, bf16), its forward and its backward
(``flash_attention_bwd``), timed on one CUDA card for one checkout.

    python3 src/repro_torch/bench/k2_bwd.py SRC_DIR [fwd]

Imports ``repro_torch`` from ``SRC_DIR`` (this checkout's ``src`` or an
older one's, unpacked beside it), so that two commits can be compared in
turns on the same card: parent, change, change, parent.  With torch.profiler
over calls that rotate through input sets beyond the L2 cache it reads:

- the forward at the six shapes ``PERF.md`` reports for it: the
  llama3.1-8b prefills of ``chip_smoke.py`` phase [4], whisper's encoder
  and cross attention and internvl2's prefill of phase [15], and
  qwen3-0.6b's training shape (B 4, S 4,096, 16/8 heads, Dh 128, causal,
  with the rows' log-sum-exp): the device ms of the kernel a launch, the
  same for SDPA (``scaled_dot_product_attention``, every kernel of its
  call), and a digest of the output's and the log-sum-exp's bits on
  seeded inputs, so that two checkouts can be held bit for bit;
- unless ``fwd`` is given, the backward at phase [18]'s shapes (qwen3-0.6b's training
  shape, whisper's encoder B 2, S 1,500, 16/16 heads, Dh 64, and cross
  attention, Sq 512 against Sk 1,500): the device ms of one call (every
  kernel of it) and of each of its three kernels a launch (D, dK/dV, dQ).

It prints one JSON line with them and the card's name and power limit.
"""
import hashlib
import json
import math
import subprocess
import sys
from pathlib import Path

# (B, Sq, Sk, H, KV, Dh, causal), as chip_smoke.K2_BWD_CASES
CASES = ((4, 4096, 4096, 16, 8, 128, True),
         (2, 1500, 1500, 16, 16, 64, False),
         (2, 512, 1500, 16, 16, 64, False))
# (B, Sq, Sk, H, KV, Dh, causal, with the log-sum-exp)
FWD_CASES = ((8, 512, 512, 32, 8, 128, True, False),
             (32, 128, 128, 32, 8, 128, True, False),
             (16, 1500, 1500, 16, 16, 64, False, False),
             (16, 512, 1500, 16, 16, 64, False, False),
             (16, 768, 768, 14, 2, 64, True, False),
             (4, 4096, 4096, 16, 8, 128, True, True))
L2_BYTES = 50 * 2 ** 20
PARTS = ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")


def device_ms(torch, fn, sets, parts=PARTS, calls=8, passes=3):
    """Device ms of one call of ``fn`` (all its kernels) and of each kernel
    of ``parts`` a launch, from one profiler pass after a warm-up.  A
    trace can lose its records: a pass that holds none is made again, up
    to ``passes`` in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    for _ in range(passes):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for i in range(calls):
                fn(*sets[i % len(sets)])
            torch.cuda.synchronize()
        events = [e for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        if events:
            break
    else:
        raise RuntimeError(f"{passes} traces hold no device work")
    out = dict(call=sum(e.device_time_total for e in events) / 1e3 / calls)
    for part in parts:
        mine = [e.device_time_total for e in events if part in e.name]
        out[part] = sum(mine) / 1e3 / max(len(mine), 1)
    return out


def _digest(torch, *tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def forward_rows(torch, fa_ops, randn):
    rows = []
    for b, sq, sk, h, kv, dh, causal, with_lse in FWD_CASES:
        nbytes = 2 * (2 * b * sq * h * dh + 2 * b * sk * kv * dh)
        sets = [(randn((b, sq, h, dh)), randn((b, sk, kv, dh)),
                 randn((b, sk, kv, dh)))
                for _ in range(max(2, math.ceil(3 * L2_BYTES / nbytes)))]

        def fwd(q, k, v):
            if with_lse:
                return fa_ops.flash_attention_lse(q, k, v, causal=causal)
            return fa_ops.flash_attention(q, k, v, causal=causal)

        def sdpa(q, k, v):
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=True)

        out, lse = fa_ops.flash_attention_lse(*sets[0], causal=causal)
        mine = device_ms(torch, fwd, sets, ("flash_fwd",), calls=20)
        lib = device_ms(torch, sdpa, sets, (), calls=20)
        rows.append(dict(shape=[b, sq, sk, h, kv, dh, causal, with_lse],
                         device_ms=mine["flash_fwd"],
                         sdpa_device_ms=lib["call"],
                         digest=_digest(torch, out, lse)))
        del sets, out, lse
        torch.cuda.empty_cache()
    return rows


def backward_rows(torch, fa_ops, randn):
    rows = []
    for b, sq, sk, h, kv, dh, causal in CASES:
        nbytes = 2 * (4 * b * sq * h * dh + 4 * b * sk * kv * dh)
        sets = []
        for _ in range(max(2, math.ceil(3 * L2_BYTES / nbytes))):
            q, k, v = randn((b, sq, h, dh)), randn((b, sk, kv, dh)), \
                randn((b, sk, kv, dh))
            out, lse = fa_ops.flash_attention_lse(q, k, v, causal=causal)
            sets.append((q, k, v, out, lse, randn((b, sq, h, dh))))

        def bwd(q, k, v, out, lse, dout):
            return fa_ops.flash_attention_bwd(q, k, v, out, lse, dout,
                                              causal=causal)

        rows.append(dict(shape=[b, sq, sk, h, kv, dh, causal],
                         device_ms=device_ms(torch, bwd, sets)))
        del sets
        torch.cuda.empty_cache()
    return rows


def main(src: str, only: str = "") -> None:
    if only not in ("", "fwd"):
        raise SystemExit(f"unknown argument {only!r}: fwd or nothing")
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd needs a CUDA card")
    _build.build(("flash_attention",)
                 + (() if only else ("flash_attention_bwd",)))
    gen = torch.Generator("cuda").manual_seed(18)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    out = dict(src=src, fwd=forward_rows(torch, fa_ops, randn))
    if not only:
        out["rows"] = backward_rows(torch, fa_ops, randn)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:])
