"""RMSNorm, plain and fused with the residual add: CUDA kernel, plain
version and wrapper."""
