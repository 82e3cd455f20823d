"""Fused RMSNorm: Triton kernel, plain version and wrapper."""
