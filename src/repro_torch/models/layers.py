"""Shared layers: initializers, RMSNorm, rotary embeddings, gated MLPs.

Plain functions on tensors, as in the JAX package's ``models/layers.py``:
parameters are nested dicts of tensors with the JAX leaf names and layout
(``(d_in, d_out)`` weights). Initializers take an explicit
``torch.Generator``; tensors are made on that generator's device.

``kernel_mode`` selects the norm: ``"kernel"`` goes through the RMSNorm
wrapper (the CUDA kernel for CUDA tensors, the plain version on the CPU),
``"reference"`` takes the plain version everywhere.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.dist.api import split_at
from repro_torch.kernels.fused_rmsnorm import ops as rms_ops
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref

Params = Dict[str, torch.Tensor]
KERNEL_MODES = ("kernel", "reference")


def check_kernel_mode(kernel_mode: str) -> None:
    if kernel_mode not in KERNEL_MODES:
        raise ValueError(f"kernel_mode must be one of {KERNEL_MODES}, got {kernel_mode!r}")


# ---------------------------------------------------------------------------
# Initializers (``lead`` prepends stacking axes, e.g. (n_layers,))
# ---------------------------------------------------------------------------


def dense_init(
    gen: torch.Generator, in_dim: int, out_dim: int, dtype: torch.dtype,
    lead: Tuple[int, ...] = (),
) -> torch.Tensor:
    w = torch.randn(*lead, in_dim, out_dim, generator=gen, device=gen.device)
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(
    gen: torch.Generator, vocab: int, dim: int, dtype: torch.dtype
) -> torch.Tensor:
    t = torch.randn(vocab, dim, generator=gen, device=gen.device)
    return t.mul_(0.02).to(dtype)


def rmsnorm_init(
    dim: int, dtype: torch.dtype, device: Union[str, torch.device],
    lead: Tuple[int, ...] = (),
) -> Params:
    return {"scale": torch.ones(*lead, dim, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_head(
    scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6, *,
    kernel_mode: str = "kernel",
) -> torch.Tensor:
    """Normalize the last dim with a shared scale vector (also qk-norm).
    fp32 statistics, output in ``x.dtype``."""
    if kernel_mode == "reference":
        return rmsnorm_ref(x, scale, eps=eps)
    return rms_ops.rmsnorm(x, scale, eps=eps)


def rmsnorm(
    params: Params, x: torch.Tensor, eps: float = 1e-6, *, kernel_mode: str = "kernel"
) -> torch.Tensor:
    return rmsnorm_head(params["scale"], x, eps, kernel_mode=kernel_mode)


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(
    head_dim: int, theta: float, device: Union[str, torch.device]
) -> torch.Tensor:
    """Inverse frequencies for the head_dim//2 rotation planes."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(
    x: torch.Tensor,  # (..., seq, heads, head_dim)
    positions: torch.Tensor,  # (..., seq)
    theta: float,
) -> torch.Tensor:
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * inv_freq  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Split of the head_dim//2 frequency planes into (t, h, w) sections:
    Qwen2-VL's [16, 24, 24] at head_dim 128, in the ratio 2:3:3 at others."""
    half = head_dim // 2
    t = max(1, round(half * 2 / 8))
    h = max(1, round(half * 3 / 8))
    return t, h, half - t - h


def apply_mrope(
    x: torch.Tensor,  # (batch, seq, heads, head_dim)
    positions: torch.Tensor,  # (batch, 3, seq): (temporal, height, width) ids
    theta: float,
) -> torch.Tensor:
    """Multimodal RoPE: frequency plane ``i`` turns by the position id of
    the section that owns it (the first ``t`` planes by the temporal id,
    the next ``h`` by the height id, the rest by the width id)."""
    inv_freq = rope_frequencies(x.shape[-1], theta, x.device)
    owner = torch.tensor([i for i, n in enumerate(mrope_sections(x.shape[-1])) for _ in range(n)],
                         device=x.device)  # (half,)
    ang = positions[..., None].float() * inv_freq  # (b, 3, s, half)
    angles = torch.gather(ang, 1, owner.expand(ang.shape[0], 1, ang.shape[2], -1))[:, 0]
    cos = torch.cos(angles)[..., None, :]  # (b, s, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def positions_from_tokens(
    batch: int, seq: int, offset: int = 0, *, device: Union[str, torch.device]
) -> torch.Tensor:
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def mlp_init(
    gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
    lead: Tuple[int, ...] = (),
) -> Params:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_up": dense_init(gen, d_model, d_ff, dtype, lead),
        "w_down": dense_init(gen, d_ff, d_model, dtype, lead),
    }


def mlp_apply(params: Params, x: torch.Tensor, act: str, d_ff: int) -> torch.Tensor:
    """The gated MLP of hidden width ``d_ff``. Where the model axis splits
    ``d_ff``, the params are the rank's pieces: ``w_gate`` / ``w_up``
    column-parallel, ``w_down`` row-parallel and its output all-reduced."""
    ax = split_at((None, "model"), (x.shape[-1], d_ff))
    x = ax.copy(x)
    gate = x @ params["w_gate"]
    up = x @ params["w_up"]
    if act == "silu":
        gate = F.silu(gate)
    elif act == "gelu":
        gate = F.gelu(gate, approximate="tanh")
    else:
        raise ValueError(f"unknown activation {act}")
    return ax.reduce((gate * up) @ params["w_down"])


# ---------------------------------------------------------------------------
# Softmax cross entropy (fp32, stable)
# ---------------------------------------------------------------------------


def softmax_cross_entropy(
    logits: torch.Tensor,  # (..., vocab)
    labels: torch.Tensor,  # (...)
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean negative log-likelihood in fp32; with a mask, the masked sum
    over the mask's sum (at least 1)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
