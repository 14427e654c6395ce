"""RMSNorm (optional fused residual add): CUDA kernel wrapper + plain version."""
