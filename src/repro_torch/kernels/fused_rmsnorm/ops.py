"""Public RMSNorm wrapper: arbitrary leading dims, dispatch on the tensor's
device. A CPU tensor takes the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the hand-written kernel (``csrc/rmsnorm.cu``) or raises on
a dtype, shape or layout the kernel does not take.

The kernel's launch shape — elements a vector, threads a row, vectors a
thread — is chosen here (``launch_shape``), from d, the element size and
the pointers' alignment, never on failure.

``rmsnorm.launches`` counts kernel launches (never plain-version calls),
so a run can show that its path went through the kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

BLOCK = 256  # threads a block (csrc/rmsnorm.cu kBlock)
VECTOR_BYTES = 16
REGISTER_VECTORS = (1, 2, 4, 8, 16)  # vectors a thread the kernel holds in registers


class LaunchShape(NamedTuple):
    vec: int  # elements a load: 16 bytes' worth, or 1 (scalar path)
    threads_per_row: int  # a power of two up to BLOCK
    vectors_per_thread: int  # one of REGISTER_VECTORS, or 0: loop, reading the row twice
    rows_per_block: int


@functools.lru_cache(maxsize=256)
def launch_shape(d: int, element_size: int, aligned: bool = True) -> LaunchShape:
    """The kernel's launch shape for rows of ``d`` elements. 16-byte
    vectors when ``aligned`` (every pointer 16-byte aligned) and d is a
    multiple of the vector width, else scalar loads; one thread a vector
    up to BLOCK threads a row, then more vectors a thread, up to 16;
    beyond that the row is looped over and read twice."""
    vec = VECTOR_BYTES // element_size
    if not aligned or d % vec:
        vec = 1
    n_vec = -(-d // vec)
    tpr = min(BLOCK, 1 << (n_vec - 1).bit_length())
    per = -(-n_vec // tpr)
    vpt = next((v for v in REGISTER_VECTORS if v >= per), 0)
    return LaunchShape(vec, tpr, vpt, BLOCK // tpr)


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
    device = x.device
    if device.type == "cpu":
        return rmsnorm_ref(x, scale, residual, eps)
    if device.type != "cuda":
        raise ValueError(f"rmsnorm: unsupported device {device}")
    d = x.shape[-1]
    _check(x, "x", device)
    _check(scale, "scale", device)
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    ptrs = [x.data_ptr(), scale.data_ptr()]
    if residual is not None:
        _check(residual, "residual", device)
        if residual.shape != x.shape or residual.dtype != x.dtype:
            raise ValueError("residual must match x in shape and dtype")
        ptrs.append(residual.data_ptr())
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    ptrs.append(out.data_ptr())
    shape = launch_shape(d, x.element_size(), all(p % VECTOR_BYTES == 0 for p in ptrs))
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
        shape.vec,
        shape.threads_per_row,
        shape.vectors_per_thread,
        device.index,
        _build.current_stream(device.index),
    )
    _build.check(err, "rmsnorm_fwd")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
