"""WKV6 chunked scan: CUDA kernel wrapper + plain version."""
