"""K2's backward (``flash_attention_bwd``, bf16) timed on one CUDA card for
one checkout, at ``chip_smoke.py`` phase [18]'s shapes.

    python3 src/repro_torch/bench/k2_bwd.py SRC_DIR

Imports ``repro_torch`` from ``SRC_DIR`` (this checkout's ``src`` or an
older one's, unpacked beside it), so that two commits can be compared in
turns on the same card: parent, change, change, parent.  At qwen3-0.6b's
training shape (B 4, S 4,096, 16/8 heads, Dh 128, causal) and whisper's
encoder (B 2, S 1,500, 16/16 heads, Dh 64) and cross attention (Sq 512
against Sk 1,500) it reads, with torch.profiler over calls that rotate
through input sets beyond the L2 cache, the device ms of one call (every
kernel of it) and of each of its three kernels a launch (D, dK/dV, dQ),
and prints one JSON line with them and the card's name and power limit.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

# (B, Sq, Sk, H, KV, Dh, causal), as chip_smoke.K2_BWD_CASES
CASES = ((4, 4096, 4096, 16, 8, 128, True),
         (2, 1500, 1500, 16, 16, 64, False),
         (2, 512, 1500, 16, 16, 64, False))
L2_BYTES = 50 * 2 ** 20
PARTS = ("fa_bwd_delta", "fa_bwd_dkdv", "fa_bwd_dq")


def device_ms(torch, fn, sets, calls=8):
    """Device ms of one call of ``fn`` (all its kernels) and of each kernel
    of PARTS a launch, from one profiler pass after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(*sets[i % len(sets)])
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not events:
        raise RuntimeError("the trace holds no device work")
    out = dict(call=sum(e.device_time_total for e in events) / 1e3 / calls)
    for part in PARTS:
        mine = [e.device_time_total for e in events if part in e.name]
        out[part] = sum(mine) / 1e3 / max(len(mine), 1)
    return out


def main(src: str) -> None:
    sys.path.insert(0, str(Path(src).resolve()))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if not torch.cuda.is_available():
        raise SystemExit("k2_bwd needs a CUDA card")
    _build.build(("flash_attention", "flash_attention_bwd"))
    gen = torch.Generator("cuda").manual_seed(18)

    def randn(shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

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
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps(dict(src=src, card=card, rows=rows)))


if __name__ == "__main__":
    main(sys.argv[1])
