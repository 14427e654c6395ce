"""Architecture registry of the port: ``get_config(name)``.

Holds every arch of the JAX package's registry, copied from its
``configs/gemma_2b.py``, ``configs/qwen3_8b.py``, ``configs/rwkv6_7b.py``,
``configs/qwen1p5_32b.py``, ``configs/qwen2_72b.py``,
``configs/mixtral_8x22b.py``, ``configs/qwen3_moe_235b.py``,
``configs/hymba_1p5b.py``, ``configs/qwen2_vl_72b.py`` and
``configs/musicgen_medium.py``; any other name raises ``KeyError``. The
workload shapes (``SHAPES``, ``TRAIN_4K``, ``DECODE_32K``) are copies of
``configs/base.py``'s, and ``get_shape``, ``all_cells`` and
``skipped_cells`` its registry's.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ArchConfig,
    ShapeConfig,
)

# gemma-2b — dense, GeGLU, MQA (kv=1), head_dim=256 [arXiv:2403.08295].
# Tied embeddings scaled by sqrt(d_model).
GEMMA_2B = ArchConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    gated_act="gelu",
    rope_variant="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    scale_embeddings=True,
)

# qwen3-8b — dense, GQA + qk_norm [hf:Qwen/Qwen3-8B].
QWEN3_8B = ArchConfig(
    name="qwen3-8b",
    family="dense",
    n_layers=36,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12288,
    vocab_size=151936,
    qk_norm=True,
    gated_act="silu",
    rope_variant="rope",
    rope_theta=1_000_000.0,
)

# rwkv6-7b (Finch) — attention-free, data-dependent decay [arXiv:2404.05892].
# Time-mix heads of size 64 (64 heads); recurrent state, no KV cache.
RWKV6_7B = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # d_model / rwkv_head_dim
    n_kv_heads=0,  # attention-free
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    rope_variant="none",
)

# qwen1.5-32b — dense, MHA with QKV bias [hf:Qwen/Qwen1.5 family].
QWEN1P5_32B = ArchConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    head_dim=128,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    gated_act="silu",
    rope_variant="rope",
    rope_theta=1_000_000.0,
)

# qwen2-72b — dense, GQA + QKV bias [arXiv:2407.10671].
QWEN2_72B = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    gated_act="silu",
    rope_variant="rope",
    rope_theta=1_000_000.0,
)

# mixtral-8x22b — MoE 8 experts top-2, sliding-window attention
# [arXiv:2401.04088].
MIXTRAL_8X22B = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    gated_act="silu",
    rope_variant="rope",
    rope_theta=1_000_000.0,
)

# qwen3-moe-235b-a22b — MoE, 128 experts top-8, qk-norm
# [hf:Qwen/Qwen3-30B-A3B family].
QWEN3_MOE_235B = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    top_k=8,
    qk_norm=True,
    gated_act="silu",
    rope_variant="rope",
    rope_theta=1_000_000.0,
)

# hymba-1.5b — hybrid: sliding-window attention and Mamba heads in
# parallel on the same input, their outputs averaged [arXiv:2411.13676].
HYMBA_1P5B = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    ssm_conv=4,
    sliding_window=1024,
    gated_act="silu",
    rope_variant="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
)

# qwen2-vl-72b — the qwen2-72b backbone with M-RoPE; the vision tower is a
# stub: precomputed patch embeddings are spliced over the first tokens,
# and positions are (temporal, height, width) ids [arXiv:2409.12191].
QWEN2_VL_72B = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    qkv_bias=True,
    gated_act="silu",
    rope_variant="mrope",
    rope_theta=1_000_000.0,
    frontend="vision_patches",
    n_frontend_tokens=256,
)

# musicgen-medium — a decoder over EnCodec audio tokens; the EnCodec
# frontend is a stub: precomputed frame embeddings take the place of an
# embedding table [arXiv:2306.05284].
MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    gated_act="gelu",
    rope_variant="none",
    frontend="audio_frames",
)

# in the JAX registry's order, which ``all_cells`` keeps
ARCHS: Dict[str, ArchConfig] = {
    c.name: c for c in (HYMBA_1P5B, QWEN3_MOE_235B, MIXTRAL_8X22B, MUSICGEN_MEDIUM, QWEN1P5_32B,
                        QWEN3_8B, GEMMA_2B, QWEN2_72B, RWKV6_7B, QWEN2_VL_72B)
}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells() -> List[tuple]:
    """Every runnable (arch, shape) cell of the assignment matrix."""
    return [(a, s) for a in ARCHS.values() for s in SHAPES.values() if a.supports(s)]


def skipped_cells() -> List[tuple]:
    return [(a, s) for a in ARCHS.values() for s in SHAPES.values() if not a.supports(s)]


__all__ = [
    "ArchConfig", "ARCHS", "DECODE_32K", "LONG_500K", "PREFILL_32K", "all_cells", "get_shape",
    "skipped_cells", "GEMMA_2B", "HYMBA_1P5B", "MIXTRAL_8X22B",
    "MUSICGEN_MEDIUM", "QWEN1P5_32B", "QWEN2_72B", "QWEN2_VL_72B", "QWEN3_8B", "QWEN3_MOE_235B",
    "RWKV6_7B", "SHAPES", "ShapeConfig", "TRAIN_4K", "get_config",
]
