"""Prefill flash attention: CUDA kernel, plain version and wrapper."""
