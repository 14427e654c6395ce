"""Architecture registry of the port: ``get_config(name)``.

Holds the dense configs the port runs so far, copied from the JAX
package's ``configs/gemma_2b.py`` and ``configs/qwen3_8b.py``. Any other
arch of the JAX registry raises ``KeyError`` until it is ported.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchConfig

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

ARCHS: Dict[str, ArchConfig] = {c.name: c for c in (GEMMA_2B, QWEN3_8B)}


def get_config(name: str) -> ArchConfig:
    if name.endswith("-smoke"):
        return get_config(name[: -len("-smoke")]).smoke()
    if name not in ARCHS:
        raise KeyError(
            f"arch {name!r} is not yet ported to repro_torch; ported: {sorted(ARCHS)}"
        )
    return ARCHS[name]


__all__ = ["ArchConfig", "ARCHS", "GEMMA_2B", "QWEN3_8B", "get_config"]
