"""Plain PyTorch WKV6: the step-by-step linear recurrence per head,

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

the JAX package's oracle (``kernels/rwkv_scan/ref.py``) with a Python loop
in place of ``lax.scan``. It is the CPU path of ``ops.wkv6`` and the
yardstick its CUDA kernel is held against on the card. The tests rehearse
the CUDA kernel's own arithmetic (``tests/wkv6_rehearsal.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def wkv6_ref(
    r: torch.Tensor,  # (b, s, h, dk) fp32
    k: torch.Tensor,  # (b, s, h, dk)
    v: torch.Tensor,  # (b, s, h, dv)
    w: torch.Tensor,  # (b, s, h, dk), decay in (0, 1)
    u: torch.Tensor,  # (h, dk)
    s0: Optional[torch.Tensor] = None,  # (b, h, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(o (b, s, h, dv), final state (b, h, dk, dv))``."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    state = (
        torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
        if s0 is None else s0
    )
    outs = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]  # (b, h, dk, dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u[..., :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1), state
