"""Attention for the prefill path: GQA/MQA, qk-norm, QKV bias, RoPE.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package's ``models/attention.py``. Causal attention goes through the
flash-attention wrapper (the CUDA kernel for CUDA tensors, the plain
version on the CPU) under ``kernel_mode="kernel"``, and through the plain
version everywhere under ``"reference"``. Sliding-window chunking, M-RoPE,
KV quantization and decode are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import Params, apply_rope, dense_init, rmsnorm_head


def attention_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, lead: Tuple[int, ...] = ()
) -> Params:
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype, lead),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, lead),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, lead),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype, lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(*lead, cfg.q_dim, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(*lead, cfg.kv_dim, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(*lead, cfg.kv_dim, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=dev)
    return p


def full_attention(
    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, sk, hkv, d)
    v: torch.Tensor,  # (b, sk, hkv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kernel_mode: str = "kernel",
) -> torch.Tensor:
    """Exact softmax attention with grouped KV heads, fp32 softmax."""
    if kernel_mode == "reference":
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    # the kernel tiles internally: blocks as large as the sequences keep the
    # wrapper's divisibility contract trivially satisfied
    return fa_ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        block_q=q.shape[1], block_k=k.shape[1],
    )


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, *, kernel_mode: str = "kernel"):
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    b, s = x.shape[0], x.shape[1]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm_head(p["q_norm"], q, cfg.norm_eps, kernel_mode=kernel_mode)
        k = rmsnorm_head(p["k_norm"], k, cfg.norm_eps, kernel_mode=kernel_mode)
    return q, k, v


def _apply_positions(cfg: ArchConfig, q, k, positions):
    if cfg.rope_variant == "none":
        return q, k
    if cfg.rope_variant != "rope":
        raise NotImplementedError(f"rope_variant {cfg.rope_variant!r} is not ported yet")
    return apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)


def attend(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
    kernel_mode: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over the full sequence; returns the output
    projection and the layer's (rotated) keys and values, which prefill
    keeps as its KV cache."""
    q, k, v = _project_qkv(p, cfg, x, kernel_mode=kernel_mode)
    q, k = _apply_positions(cfg, q, k, positions)
    out = full_attention(
        q, k, v, causal=True, window=cfg.sliding_window or None, kernel_mode=kernel_mode
    )
    b, s = x.shape[0], x.shape[1]
    return out.reshape(b, s, cfg.q_dim) @ p["wo"], k, v


def attention_apply(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
    kernel_mode: str = "kernel",
) -> torch.Tensor:
    """Training / prefill path over the full sequence (causal)."""
    return attend(p, cfg, x, positions, kernel_mode=kernel_mode)[0]


def cache_capacity(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, seq_len)
    return seq_len
