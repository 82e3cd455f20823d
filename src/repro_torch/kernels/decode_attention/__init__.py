"""Decode (single-query) attention: CUDA kernel, plain version and wrapper."""
