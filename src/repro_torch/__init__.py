"""PyTorch + CUDA port of the Salus reproduction, for an NVIDIA H100.

Beside the JAX package ``repro`` (the reference, which this package never
imports): the live execution service (``repro_torch.core``), the models
of every arch of the JAX registry in prefill, decode and the loss
(``repro_torch.models``), hand-written CUDA kernels for RMSNorm, flash
attention and the WKV6 scan (``repro_torch.kernels``, sources in
``repro_torch/csrc``), the serve driver (``repro_torch.launch.serve``)
and device selection (``repro_torch.device.device``).
"""
