"""Fused RMSNorm Triton kernel for Hopper.

Replaces the TPU kernel ``src/repro/kernels/rmsnorm/kernel.py::rmsnorm_2d``
(body ``_rmsnorm_kernel``): ``y = x * rsqrt(mean(x^2) + eps) * scale`` per
row, math in fp32, cast back to ``x.dtype``.

What bounds it on the H100: a few flops per element against two bytes read
and written (bf16), so it is bound by bytes.  What the design does about
that: one program per row holds the whole row in registers
(``BLOCK_D = next_pow2(d)``, masked), so ``x`` is read from device memory
once and written once, where unfused code reads it twice.

``triton`` is imported, and the kernel defined, at the first launch, not
with this module: a CPU-only install has no ``triton`` and must still
import the package.
"""
from __future__ import annotations

import functools

@functools.cache
def _jit():
    """Import triton and define the kernel; called at the first launch."""
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_rows_kernel(x_ptr, scale_ptr, out_ptr, d, eps,
                            BLOCK_D: tl.constexpr):
        row = tl.program_id(0).to(tl.int64)
        cols = tl.arange(0, BLOCK_D)
        mask = cols < d
        x = tl.load(x_ptr + row * d + cols, mask=mask,
                    other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=0) / d
        y = x / tl.sqrt(var + eps)
        w = tl.load(scale_ptr + cols, mask=mask, other=0.0).to(tl.float32)
        tl.store(out_ptr + row * d + cols,
                 (y * w).to(out_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_rows_kernel


def rmsnorm_rows(x2, scale, out2, eps: float) -> None:
    """x2, out2: contiguous (n, d) on one card; scale: contiguous (d,)."""
    n, d = x2.shape
    block_d = 1 << max(d - 1, 0).bit_length()
    num_warps = min(16, max(1, block_d // 512))
    _jit()[(n,)](x2, scale, out2, d, eps, BLOCK_D=block_d,
                 num_warps=num_warps)
