"""Public RMSNorm wrapper: arbitrary leading dims, dispatch on the tensor's
device. A CPU tensor takes the plain version (``ref.rmsnorm_ref``); a CUDA
tensor launches the hand-written kernel (``csrc/rmsnorm.cu``) or raises on
a dtype, shape or layout the kernel does not take.

The kernel's launch shape — elements a vector, threads a row, vectors a
thread — is chosen here (``launch_shape``), from d, the element size and
the pointers' alignment, never on failure.

Under autograd (grad enabled and an input that requires grad) a CUDA
call goes through ``RMSNormFunction``, whose backward is the hand-written
kernel ``rmsnorm_bwd`` (``csrc/rmsnorm.cu``); ``rmsnorm_bwd`` is also
public, with the plain ``ref.rmsnorm_bwd_ref`` on the CPU. Its launch
shape (row slots a block, the depth of its cp.async ring) and block count
are pure functions here (``bwd_launch_shape``, ``bwd_blocks``), cached,
and its dscale partials live in one scratch a (device, stream). The residual
form (K2) has no backward kernel yet and raises under autograd on CUDA
rather than cut the gradient.

``rmsnorm.launches`` and ``rmsnorm_bwd.launches`` count kernel launches
(never plain-version calls), so a run can show that its path went through
the kernels.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref

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


BWD_REGISTER_VALUES = 32  # csrc/rmsnorm.cu kBwdRegisterValues
BWD_BLOCK = 512  # threads a backward block (csrc/rmsnorm.cu kBwdBlock)
BWD_MAX_STAGES = 4  # rows of x and g a thread may keep in flight (kBwdMaxStages)
BWD_STAGES = 3  # the ring's depth where it fits the budget, else one row
BWD_RING_BYTES = 96 << 10  # the ring's budget a block
BWD_MAX_SMEM = 128 << 10  # shared memory a block at most (kBwdMaxSmem)


class BwdShape(NamedTuple):
    vec: int  # elements a load
    threads_per_row: int  # BWD_BLOCK for the looping form
    vectors_per_thread: int  # 0: the looping form
    rows_per_block: int  # row slots of a block
    stages: int  # rows of the cp.async ring a slot (1 where there is no ring)


@functools.lru_cache(maxsize=256)
def bwd_launch_shape(d: int, element_size: int, aligned: bool = True) -> BwdShape:
    """The backward kernel's launch shape: the forward's threads a row and
    vectors a thread, except that a row of 129-256 vectors takes 128
    threads with two vectors each (at gemma-2b's 2048 bf16 the fastest of
    every shape the kernel takes, ``scripts/flash_bwd_kernel_times.py
    --sweep``), in 512-thread blocks of ``512 / tpr`` row slots, with a
    ring of three rows of x and g a slot in shared memory (16-byte loads
    only) where it fits 96 KB a block, else of one. A row whose thread
    would hold more than 32 values of each of x, g and its sums (rows of
    16k elements or more) takes the looping form, one row a block, which
    reads the row twice, rather than spill registers."""
    fwd = launch_shape(d, element_size, aligned)
    if not 0 < fwd.vectors_per_thread * fwd.vec <= BWD_REGISTER_VALUES:
        return BwdShape(fwd.vec, BWD_BLOCK, 0, 1, 1)
    tpr, vpt = fwd.threads_per_row, fwd.vectors_per_thread
    stages = 1
    if fwd.vec * element_size == VECTOR_BYTES:
        if tpr == BLOCK and vpt == 1:
            tpr, vpt = BLOCK // 2, 2
        row_slot_bytes = 2 * BWD_BLOCK * vpt * VECTOR_BYTES  # x and g, all slots
        stages = BWD_STAGES if BWD_STAGES * row_slot_bytes <= BWD_RING_BYTES else 1
    return BwdShape(fwd.vec, tpr, vpt, BWD_BLOCK // tpr, stages)


def bwd_smem_bytes(shape: BwdShape, d: int, element_size: int) -> int:
    """Dynamic shared memory of a backward block (csrc/rmsnorm.cu
    ``bwd_smem_bytes``): the ring, or the block's dscale rows (one a slot,
    one a warp where a warp holds several slots), whichever is larger; 0
    for the looping form."""
    if shape.vectors_per_thread == 0:
        return 0
    ring = 0
    if shape.vec * element_size == VECTOR_BYTES:
        ring = shape.stages * 2 * BWD_BLOCK * shape.vectors_per_thread * VECTOR_BYTES
    sums = BWD_BLOCK // max(shape.threads_per_row, 32) * d * 4
    return max(ring, sums)


@functools.lru_cache(maxsize=16)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def bwd_blocks(rows: int, shape: BwdShape, sm_count: int) -> int:
    """Blocks of the backward kernel: one a group of ``rows_per_block``
    rows, at most one an SM (the sweep's best at all three training
    shapes). Each block writes one partial row of the scale's gradient,
    which a second kernel sums in block order."""
    return max(1, min(-(-rows // shape.rows_per_block), sm_count))


# dscale partials, one fp32 scratch a (device, stream), grown as needed:
# kernels on one stream run in order, so a call's partials are read before
# the next call on that stream writes them
_partials: dict = {}


def _partials_for(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    buf = _partials.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.empty(n, dtype=torch.float32, device=device)
        _partials[key] = buf
    return buf


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
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, scale, residual)
    ):
        if residual is not None:
            raise NotImplementedError(
                "rmsnorm: the residual form has no backward kernel yet; "
                "call it without autograd"
            )
        return RMSNormFunction.apply(x, scale, eps)
    return _forward(x, scale, residual, eps)


def _forward(x, scale, residual, eps):
    device = x.device
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
    _build.count_launch(rmsnorm)
    return out


rmsnorm.launches = 0


class RMSNormFunction(torch.autograd.Function):
    """The no-residual RMSNorm kernel with its backward kernel. Saves x and
    the scale; the backward reads the stream current on its own thread."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _forward(x, scale, None, eps)

    @staticmethod
    def backward(ctx, g):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(g, x, scale, eps=ctx.eps)
        return dx, dscale, None


def rmsnorm_bwd(
    g: torch.Tensor,  # (..., d), the output's gradient
    x: torch.Tensor,  # (..., d)
    scale: torch.Tensor,  # (d,)
    *,
    eps: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dscale)`` of the no-residual RMSNorm: dx in x's dtype, dscale
    in the scale's. A CPU tensor takes ``ref.rmsnorm_bwd_ref``; a CUDA
    tensor launches the backward kernel (``g`` is made contiguous)."""
    device = x.device
    if device.type == "cpu":
        return rmsnorm_bwd_ref(g, x, scale, eps)
    if device.type != "cuda":
        raise ValueError(f"rmsnorm_bwd: unsupported device {device}")
    d = x.shape[-1]
    g = g.contiguous()
    _check(x, "x", device)
    _check(scale, "scale", device)
    _check(g, "g", device)
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError("g must match x in shape and dtype")
    if scale.shape != (d,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({d},)")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale)
    rows = x.numel() // d
    if rows == 0:
        return dx, dscale.zero_()
    es = x.element_size()
    aligned = not (g.data_ptr() | x.data_ptr() | scale.data_ptr() | dx.data_ptr()) % VECTOR_BYTES
    shape = bwd_launch_shape(d, es, aligned)
    blocks = bwd_blocks(rows, shape, _sm_count(device.index))
    stream = _build.current_stream(device.index)
    partials = _partials_for(device, stream, blocks * d)
    err = _build.library().rmsnorm_bwd(
        g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
        partials.data_ptr(), rows, d, float(eps),
        _build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[scale.dtype],
        shape.vec, shape.threads_per_row, shape.vectors_per_thread, shape.stages, blocks,
        device.index, stream,
    )
    _build.check(err, "rmsnorm_bwd")
    _build.count_launch(rmsnorm_bwd)
    return dx, dscale


rmsnorm_bwd.launches = 0
