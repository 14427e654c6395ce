"""Plain PyTorch RMSNorm with an optional fused residual add (fp32
statistics): the CPU path of ``ops.rmsnorm`` and the yardstick its CUDA
kernel is held against on the card.

With a residual it follows the Pallas kernel (``_rmsnorm_residual_kernel``),
which upcasts both inputs to fp32 *before* the add; the JAX package's
jnp oracle adds in the input dtype instead. The two agree exactly in fp32.
"""
from __future__ import annotations

from typing import Optional

import torch


def rmsnorm_ref(
    x: torch.Tensor,  # (..., d)
    scale: torch.Tensor,  # (d,)
    residual: Optional[torch.Tensor] = None,
    eps: float = 1e-6,
) -> torch.Tensor:
    x32 = x.float()
    if residual is not None:
        x32 = x32 + residual.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps) * scale.float()
    return y.to(x.dtype)
