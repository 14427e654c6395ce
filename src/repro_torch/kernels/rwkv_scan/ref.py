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


def wkv6_bwd_ref(
    do: Optional[torch.Tensor],  # (b, s, h, dv), or None: zero
    dstate: Optional[torch.Tensor],  # (b, h, dk, dv), or None: zero
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    s0: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dr, dk, dv, dw, du, ds0)`` by autograd through ``wkv6_ref`` under
    the cotangents of ``(o, final state)``; ``ds0`` is None without ``s0``."""
    ins = [t.detach().requires_grad_() for t in (r, k, v, w, u, s0) if t is not None]
    with torch.enable_grad():
        outs = wkv6_ref(*ins)
        cots = [torch.zeros_like(y) if g is None else g for y, g in zip(outs, (do, dstate))]
        grads = torch.autograd.grad(outs, ins, cots)
    return (*grads, None) if s0 is None else grads
