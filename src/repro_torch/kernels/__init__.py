"""Hand-written CUDA kernels of the port, with their plain PyTorch
versions (``ref``) and device-dispatching wrappers (``ops``)."""
