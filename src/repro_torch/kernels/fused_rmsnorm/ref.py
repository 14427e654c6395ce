"""Plain PyTorch RMSNorm with an optional fused residual add (fp32
statistics): the CPU path of ``ops.rmsnorm`` and the yardstick its CUDA
kernel is held against on the card.

With a residual it follows the Pallas kernel (``_rmsnorm_residual_kernel``),
which upcasts both inputs to fp32 *before* the add; the JAX package's
jnp oracle adds in the input dtype instead. The two agree exactly in fp32.
"""
from __future__ import annotations

from typing import Optional, Tuple

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


def rmsnorm_bwd_ref(
    g: torch.Tensor,  # (..., d), the output's gradient
    x: torch.Tensor,  # (..., d)
    scale: torch.Tensor,  # (d,)
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of the no-residual ``rmsnorm_ref`` by its explicit
    formula, fp32 inside: with ``r = rsqrt(mean(x²) + eps)`` and ``s`` the
    scale, ``dx = r (g s) - x r³ mean((g s) x)`` in x's dtype and ``dscale =
    Σ_rows g x r`` in the scale's dtype. The backward kernel's plain
    version (``csrc/rmsnorm.cu::rmsnorm_bwd``)."""
    d = x.shape[-1]
    x32 = x.float().reshape(-1, d)
    g32 = g.float().reshape(-1, d)
    s32 = scale.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    gs = g32 * s32
    dx = r * gs - x32 * r.pow(3) * (gs * x32).mean(dim=-1, keepdim=True)
    dscale = (g32 * x32 * r).sum(dim=0)
    return dx.reshape(x.shape).to(x.dtype), dscale.to(scale.dtype)
