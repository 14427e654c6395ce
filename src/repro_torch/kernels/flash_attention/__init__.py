"""Flash attention: CUDA kernel wrapper + plain version."""
