"""Public WKV6 wrapper in the model layout ``(b, s, h, d)``, dispatching on
the tensors' device. Every input is fp32 on one device, on both paths.
CPU tensors take the plain version (``ref.wkv6_ref``); CUDA tensors
launch the hand-written kernel (``csrc/wkv6.cu``) or raise on a head
size, chunk or layout it does not take.

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

There is no WKV6 backward kernel yet: on CUDA tensors under autograd
(grad enabled and an input that requires grad) ``wkv6`` raises
``NotImplementedError`` rather than return an output that cuts the
gradient. CPU tensors keep the plain version, with autograd through it.

``wkv6.launches`` counts kernel launches (never plain-version calls).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref

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
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    chunk = min(chunk, s)
    if chunk < 1 or (s % chunk and not ragged):
        raise ValueError(f"seq {s} must divide chunk {chunk}")
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
    if r.device.type == "cpu":
        return wkv6_ref(r, k, v, w, u, s0)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6: unsupported device {r.device}")
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (r, k, v, w, u, s0)
    ):
        raise NotImplementedError(
            "wkv6: the WKV6 kernel has no backward yet (rwkv training waits for "
            "it); call it under torch.no_grad() or with inputs that need no grad"
        )
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    if not u.is_contiguous() or (s0 is not None and not s0.is_contiguous()):
        raise ValueError("u and s0 must be contiguous")
    if dk not in HEAD_DIMS or dv not in HEAD_DIMS:
        raise ValueError(f"head sizes ({dk}, {dv}) not supported; kernel takes {HEAD_DIMS}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}, the kernel's largest")
    o = torch.empty((b, s, h, dv), dtype=torch.float32, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    if o.numel() == 0:
        return o, (state.zero_() if s0 is None else state.copy_(s0))
    dev = r.device.index if r.device.index is not None else torch.cuda.current_device()
    err = _build.library().wkv6_fwd_tiled(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), o.data_ptr(), state.data_ptr(),
        b, s, h, dk, dv, chunk,
        r.stride(0), r.stride(1), r.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        w.stride(0), w.stride(1), w.stride(2),
        column_tile, dev, _build.current_stream(dev),
    )
    _build.check(err, "wkv6_fwd")
    _build.count_launch(wkv6)
    return o, state


wkv6.launches = 0
