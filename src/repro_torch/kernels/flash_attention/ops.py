"""Public flash-attention wrapper in the model layout ``(b, s, h, d)``,
dispatching on the tensors' device. CPU tensors take the plain version
(``ref.attention_ref``); CUDA tensors launch the hand-written kernel
(``csrc/flash_attention.cu``) or raise on a dtype, head size or layout it
does not take.

The kernel reads q/k/v through their batch/sequence/head strides, so the
``(b, s, h, d)`` views go in as they are (no transpose, no
``.contiguous()``); only the last dimension must be contiguous. The
output is a new contiguous ``(b, s_q, hq, d)`` tensor.

``block_q``/``block_k`` keep the JAX wrapper's contract — sequence
lengths must divide them, else ``ValueError`` — on both paths. The CUDA
kernel tiles by 64 x 64 internally whatever they are.

``flash_attention.launches`` counts kernel launches (never plain-version
calls).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)


def flash_attention(
    q: torch.Tensor,  # (b, s_q, hq, d)
    k: torch.Tensor,  # (b, s_k, hkv, d)
    v: torch.Tensor,  # (b, s_k, hkv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 128,
    block_k: int = 128,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq ({sq},{sk}) must divide blocks ({bq},{bk})")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.shape[-1] != d:
            raise ValueError(f"{name} must be (b, s, h, {d}), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; kernel takes {HEAD_DIMS}")
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or hq % hkv:
        raise ValueError("k/v must be (b, s_k, hkv, d) with hq divisible by hkv")
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    dev = q.device.index if q.device.index is not None else torch.cuda.current_device()
    err = _build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, hq, hkv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        1.0 / math.sqrt(d),
        int(causal),
        int(window or 0),
        int(q_offset),
        _build.DTYPE_CODES[q.dtype],
        dev,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_attention_fwd")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
