"""GBT gradient/hessian histograms: CUDA kernel, plain version and wrapper."""
