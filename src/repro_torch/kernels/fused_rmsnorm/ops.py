"""Public RMSNorm wrapper: arbitrary leading dims, dispatch on the tensor's
device. A CPU tensor takes the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the hand-written kernel (``csrc/rmsnorm.cu``) or raises on
a dtype, shape or layout the kernel does not take.

``rmsnorm.launches`` counts kernel launches (never plain-version calls),
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref


def _check(t: torch.Tensor, name: str, device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"{name} dtype {t.dtype} not supported (float32, bfloat16)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rmsnorm(
    x: torch.Tensor,  # (..., d)
    scale: torch.Tensor,  # (d,)
    residual: Optional[torch.Tensor] = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, residual, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {x.device}")
    d = x.shape[-1]
    _check(x, "x", x.device)
    _check(scale, "scale", x.device)
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    if residual is not None:
        _check(residual, "residual", x.device)
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError("residual must match x in shape and dtype")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    err = _build.library().rmsnorm_fwd(
        x.data_ptr(),
        residual.data_ptr() if residual is not None else None,
        scale.data_ptr(),
        out.data_ptr(),
        x.numel() // d,
        d,
        float(eps),
        _build.DTYPE_CODES[x.dtype],
        _build.DTYPE_CODES[scale.dtype],
        x.device.index if x.device.index is not None else torch.cuda.current_device(),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "rmsnorm_fwd")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
