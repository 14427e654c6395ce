"""Dense decoder blocks and the layer stack (forward only).

Layer params are a dict whose leaves carry a leading ``n_layers`` axis,
as in the JAX package's ``models/transformer.py``; ``stack_apply`` is a
Python loop over that axis in place of ``lax.scan``. Each layer's leaves
are cast to the compute dtype inside the loop, one layer at a time, so a
request never holds a second, cast copy of the whole stack.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention
from repro_torch.models.layers import Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init

# on_kv(layer_index, k, v): receives each layer's rotated keys and values
KVSink = Callable[[int, torch.Tensor, torch.Tensor], None]


def layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """All ``cfg.n_layers`` dense layers at once, leaves stacked."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet")
    lead = (cfg.n_layers,)
    return {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "attn": attention.attention_init(gen, cfg, dtype, lead),
        "mlp_norm": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, lead),
    }


def layer_slice(layers: Params, i: int, dtype: torch.dtype) -> Params:
    """Layer ``i`` of a stacked tree, floating leaves cast to ``dtype``."""
    out = {}
    for name, leaf in layers.items():
        if isinstance(leaf, dict):
            out[name] = layer_slice(leaf, i, dtype)
        else:
            t = leaf[i]
            out[name] = t.to(dtype) if t.is_floating_point() else t
    return out


def block_apply(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
    kernel_mode: str = "kernel",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One dense block; returns (x_out, k, v) with the layer's rotated
    keys and values."""
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps, kernel_mode=kernel_mode)
    attn_out, k, v = attention.attend(p["attn"], cfg, h, positions, kernel_mode=kernel_mode)
    x = x + attn_out
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps, kernel_mode=kernel_mode)
    return x + mlp_apply(p["mlp"], h, cfg.gated_act), k, v


def stack_apply(
    layers: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
    compute_dtype: torch.dtype, kernel_mode: str = "kernel",
    on_kv: Optional[KVSink] = None,
) -> torch.Tensor:
    """Run all layers in order."""
    for i in range(cfg.n_layers):
        p = layer_slice(layers, i, compute_dtype)
        x, k, v = block_apply(p, cfg, x, positions, kernel_mode=kernel_mode)
        if on_kv is not None:
            on_kv(i, k, v)
    return x
