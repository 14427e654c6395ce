"""Public WKV6 wrapper in the model layout ``(b, s, h, d)``, dispatching on
the tensors' device. Every input is fp32 on one device, on both paths.
CPU tensors take the plain version (``ref.wkv6_ref``, with autograd
through it); CUDA tensors launch the hand-written kernel
(``csrc/wkv6.cu``) or raise on a head size, chunk or layout it does not
take.

The kernel reads r/k/v/w through their batch/sequence/head strides, so
``(b, s, h, d)`` views go in as they are (no transpose, no
``.contiguous()``); only the last dimension must be contiguous. It starts
from a zero state, as the Pallas kernel does, or from ``s0`` fp32
``(b, h, dk, dv)`` (the decode carry), and returns new contiguous tensors:
``o`` fp32 ``(b, s, h, dv)`` and the final state fp32 ``(b, h, dk, dv)``.

``chunk`` keeps the JAX wrapper's contract on both paths: it is cut to
the sequence length, and a length it does not divide raises
``ValueError``, unless ``ragged=True``, when the last chunk takes what is
left (the model's prefill serves any prompt length so). The CUDA kernel
takes chunks of at most 64 steps, each computed as one of its length
rounded up to 16: sub-chunks of 16 rows whose scores against earlier rows
are one 3xTF32 tensor-core product through a reference point, the
diagonal blocks pair by pair (``csrc/wkv6.cu``; ``tests/wkv6_rehearsal.py``
rehearses its arithmetic on the CPU).

Under autograd (grad enabled and an input that requires grad) a CUDA
call goes through ``WKV6Function``: the forward kernel, then in the
backward the hand-written kernel ``wkv6_bwd`` (``csrc/wkv6_bwd.cu``), the
gradients of ``(o, final state)`` with respect to r, k, v, w, u and s0.
``wkv6_bwd`` is also public, with the plain ``ref.wkv6_bwd_ref``
(autograd through ``wkv6_ref``) on the CPU; ``tests/wkv6_bwd_rehearsal.py``
rehearses the kernel's arithmetic.

``wkv6.launches`` and ``wkv6_bwd.launches`` count kernel launches (never
plain-version calls).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref, wkv6_ref

HEAD_DIMS = (8, 16, 32, 64)
MAX_CHUNK = 64


def wkv6(
    r: torch.Tensor,  # (b, s, h, dk) fp32
    k: torch.Tensor,  # (b, s, h, dk)
    v: torch.Tensor,  # (b, s, h, dv)
    w: torch.Tensor,  # (b, s, h, dk), decay in (0, 1)
    u: torch.Tensor,  # (h, dk)
    *,
    chunk: int = 64,
    s0: Optional[torch.Tensor] = None,  # (b, h, dk, dv) fp32
    ragged: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _wkv6(r, k, v, w, u, chunk, s0, ragged, 0)


def _wkv6(r, k, v, w, u, chunk, s0, ragged, column_tile):
    """``wkv6`` with the kernel's state columns a block: ``dv``, ``dv // 2``,
    or 0 for the kernel's own choice (chip_smoke.py times both)."""
    s = r.shape[1]
    chunk = min(chunk, s)
    if chunk < 1 or (s % chunk and not ragged):
        raise ValueError(f"seq {s} must divide chunk {chunk}")
    _validate(r, k, v, w, u, s0)
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0)
    ):
        return WKV6Function.apply(r, k, v, w, u, s0, chunk, column_tile)
    return _forward(r, k, v, w, u, chunk, s0, column_tile)


def _validate(r, k, v, w, u, s0) -> None:
    """fp32 inputs on one device, of one (b, s, h) and head sizes."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    for name, t, d in (("r", r, dk), ("k", k, dk), ("v", v, dv), ("w", w, dk)):
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, expected {r.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} dtype {t.dtype} not supported (float32)")
        if t.dim() != 4 or tuple(t.shape) != (b, s, h, d):
            raise ValueError(f"{name} must be ({b}, {s}, {h}, {d}), got {tuple(t.shape)}")
    if u.device != r.device or u.dtype != torch.float32:
        raise TypeError(f"u must be float32 on {r.device}, got {u.dtype} on {u.device}")
    if tuple(u.shape) != (h, dk):
        raise ValueError(f"u must be ({h}, {dk}), got {tuple(u.shape)}")
    if s0 is not None:
        if s0.device != r.device or s0.dtype != torch.float32:
            raise TypeError(f"s0 must be float32 on {r.device}, got {s0.dtype} on {s0.device}")
        if tuple(s0.shape) != (b, h, dk, dv):
            raise ValueError(f"s0 must be ({b}, {h}, {dk}, {dv}), got {tuple(s0.shape)}")


def _check_layout(r, k, v, w, u, s0) -> None:
    """What both kernels need beyond ``_validate``'s checks."""
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    if not u.is_contiguous() or (s0 is not None and not s0.is_contiguous()):
        raise ValueError("u and s0 must be contiguous")
    dk, dv = r.shape[-1], v.shape[-1]
    if dk not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"head sizes ({dk}, {dv}) not supported; kernel takes {HEAD_DIMS}")


def _device_index(t: torch.Tensor) -> int:
    return t.device.index if t.device.index is not None else torch.cuda.current_device()


def _strides(*tensors):
    return [x for t in tensors for x in t.stride()[:3]]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _forward(r, k, v, w, u, chunk, s0, column_tile):
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    _check_layout(r, k, v, w, u, s0)
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}, the kernel's largest")
    o = torch.empty((b, s, h, dv), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    if o.numel() == 0:
        return o, (state.zero_() if s0 is None else state.copy_(s0))
    dev = _device_index(r)
    err = _build.library().wkv6_fwd_tiled(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        _ptr(s0), o.data_ptr(), state.data_ptr(),
        b, s, h, dk, dv, chunk, *_strides(r, k, v, w),
        column_tile, dev, _build.current_stream(dev),
    )
    _build.check(err, "wkv6_fwd")
    _build.count_launch(wkv6)
    return o, state


wkv6.launches = 0


class WKV6Function(torch.autograd.Function):
    """The WKV6 kernel with its backward kernel. Saves the inputs; a
    cotangent autograd does not pass (the final state's, where a loss never
    reads it) goes to the backward kernel as none."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, chunk, column_tile):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u, s0)
        return _forward(r, k, v, w, u, chunk, s0, column_tile)

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, w, u, s0 = ctx.saved_tensors
        grads = wkv6_bwd(do, dstate, r, k, v, w, u, s0)
        return (*(g if need else None for g, need in zip(grads, ctx.needs_input_grad)),
                None, None)


def wkv6_bwd(do, dstate, r, k, v, w, u, s0=None):
    """``(dr, dk, dv, dw, du, ds0)``: the gradients of ``wkv6``'s ``(o,
    final state)`` under their cotangents ``do`` fp32 ``(b, s, h, dv)`` and
    ``dstate`` fp32 ``(b, h, dk, dv)`` (either None: zero), shaped as the
    inputs, ``ds0`` None without ``s0``. A CPU tensor takes
    ``ref.wkv6_bwd_ref``; a CUDA tensor launches the backward kernel (the
    cotangents are made contiguous)."""
    _validate(r, k, v, w, u, s0)
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    for t, shape in ((do, (b, s, h, dv)), (dstate, (b, h, dk, dv))):
        if t is not None and (t.device, t.dtype, t.shape) != (r.device, torch.float32, shape):
            raise ValueError(f"a cotangent {t.dtype} {tuple(t.shape)} on {t.device}, "
                             f"expected float32 {shape} on {r.device}")
    if r.device.type == "cpu":
        return wkv6_bwd_ref(do, dstate, r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6_bwd: unsupported device {r.device}")
    _check_layout(r, k, v, w, u, s0)
    grads = [torch.empty(t.shape, dtype=torch.float32, device=r.device)
             for t in (r, k, v, w, u, s0) if t is not None]
    if r.numel() == 0:  # no step, batch entry or head: nothing to launch
        for g in grads:
            g.zero_()
        if s0 is not None and dstate is not None:
            grads[5].copy_(dstate)
        return (*grads, None) if s0 is None else tuple(grads)
    do, dstate = (None if t is None else t.contiguous() for t in (do, dstate))
    lib = _build.library()
    workspace = torch.empty(lib.wkv6_bwd_workspace(b, s, h, dk, dv), dtype=torch.float32,
                            device=r.device)
    dev = _device_index(r)
    err = lib.wkv6_bwd(
        *map(_ptr, (r, k, v, w, u, s0, do, dstate, *grads[:5])),
        _ptr(grads[5] if s0 is not None else None), workspace.data_ptr(),
        b, s, h, dk, dv, *_strides(r, k, v, w), dev, _build.current_stream(dev),
    )
    _build.check(err, "wkv6_bwd")
    _build.count_launch(wkv6_bwd)
    return (*grads, None) if s0 is None else tuple(grads)


wkv6_bwd.launches = 0
