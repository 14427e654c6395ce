"""Decoder blocks and the layer stack, for every family: the attention
families (dense, MoE, hybrid, audio, vlm) and rwkv (``family == "ssm"``).
A hybrid (hymba) block runs attention and the SSM branch in parallel on
the same normed input and averages them, ``0.5 * (attn + ssm)``.

Layer params are a dict whose leaves carry a leading ``n_layers`` axis,
as in the JAX package's ``models/transformer.py``; ``stack_apply`` is a
Python loop over that axis in place of ``lax.scan``. Each layer's leaves
are cast to the compute dtype inside the loop, one layer at a time, so a
request never holds a second, cast copy of the whole stack. A leaf may
also be a sequence of per-layer tensors: the train step passes per-layer
views of the stacked leaves, so that each layer's gradient comes out on
its own.

With ``remat`` and a gradient to take, each layer runs under
``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint`` with
``nothing_saveable``): only its input is kept, and the backward recomputes
the layer, its cast to the compute dtype included.

Every block also hands back its layer's aux loss (the MoE load-balance
loss; 0 for any other block), which ``stack_apply`` averages over
the layers, and its layer's cache entries, which ``stack_apply`` passes
to an optional sink: ``k``/``v`` (rotated keys and values) for an
attention block, and a hybrid block's SSM state besides, ``h`` (fp32)
and ``conv`` (the last pre-conv inputs); ``tmix_shift``/``cmix_shift``/``wkv``
(the token-shift carries and the fp32 wkv state) for an rwkv block.

Decode (``block_decode``, ``stack_decode``) runs one token through the
layers against the cache. The cache is stacked (leaves with a leading
``n_layers`` axis) or a tuple of per-layer dicts. ``cache_mode="carry"``
writes each layer's entries into the cache it is given, in place, and
returns it; ``"stream"`` leaves that cache as it is and returns fresh
leaves, filled layer by layer.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from torch.utils import _pytree as pytree
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import current, use_sharding
from repro_torch.models import attention, moe, rwkv, ssm
from repro_torch.models.layers import Params, mlp_apply, mlp_init, rmsnorm, rmsnorm_init

CacheEntries = Dict[str, torch.Tensor]
# on_cache(layer_index, entries): receives each layer's cache entries
CacheSink = Callable[[int, CacheEntries], None]
# a decode cache: stacked leaves, or one dict a layer
Cache = Union[Dict[str, torch.Tensor], Sequence[Dict[str, torch.Tensor]]]
CACHE_MODES = ("carry", "stream")
# a layer's aux loss: an fp32 scalar tensor (MoE), or 0.0 (no MoE layer)
Aux = Union[torch.Tensor, float]


def layer_init(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Params:
    """All ``cfg.n_layers`` layers at once, leaves stacked."""
    lead = (cfg.n_layers,)
    if cfg.family == "ssm":  # rwkv
        return {
            "norm1": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
            "tmix": rwkv.tmix_init(gen, cfg, dtype, lead),
            "norm2": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
            "cmix": rwkv.cmix_init(gen, cfg, dtype, lead),
        }
    p = {
        "attn_norm": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
        "attn": attention.attention_init(gen, cfg, dtype, lead),
        "mlp_norm": rmsnorm_init(cfg.d_model, dtype, gen.device, lead),
    }
    if cfg.family == "hybrid":
        p["ssm"] = ssm.ssm_init(gen, cfg, dtype, lead)
    if cfg.is_moe:
        p["moe"] = moe.moe_init(gen, cfg, dtype, lead)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, lead)
    return p


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
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: Optional[torch.Tensor], *,
    kernel_mode: str = "kernel", wkv_chunk: int = 64, attn_q_chunk: Optional[int] = None,
    moe_group: int = 4096, ssm_chunk: int = 128,
) -> Tuple[torch.Tensor, Aux, CacheEntries]:
    """One block; returns (x_out, the layer's aux loss, its cache entries).
    The aux loss is an fp32 scalar for an MoE block and the float 0 for
    any other."""
    if cfg.family == "ssm":
        h = rmsnorm(p["norm1"], x, cfg.norm_eps, kernel_mode=kernel_mode)
        out, (tshift, state) = rwkv.tmix_apply(
            p["tmix"], cfg, h, kernel_mode=kernel_mode, chunk=wkv_chunk
        )
        x = x + out
        h = rmsnorm(p["norm2"], x, cfg.norm_eps, kernel_mode=kernel_mode)
        out, cshift = rwkv.cmix_apply(p["cmix"], cfg, h)
        return x + out, 0.0, {"tmix_shift": tshift, "cmix_shift": cshift, "wkv": state}
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps, kernel_mode=kernel_mode)
    attn_out, k, v = attention.attend(
        p["attn"], cfg, h, positions, kernel_mode=kernel_mode, q_chunk=attn_q_chunk
    )
    entries = {"k": k, "v": v}
    if cfg.family == "hybrid":  # hymba's parallel heads, on the same input
        ssm_out, (entries["h"], entries["conv"]) = ssm.ssm_apply(
            p["ssm"], cfg, h, chunk=ssm_chunk, return_state=True
        )
        attn_out = 0.5 * (attn_out + ssm_out)
    x = x + attn_out
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps, kernel_mode=kernel_mode)
    aux: Aux = 0.0
    if cfg.is_moe:
        out, aux = moe.moe_apply(p["moe"], cfg, h, group_size=moe_group)
    else:
        out = mlp_apply(p["mlp"], h, cfg.gated_act, cfg.d_ff)
    return x + out, aux, entries


def stack_apply(
    layers: Params, cfg: ArchConfig, x: torch.Tensor, positions: Optional[torch.Tensor], *,
    compute_dtype: torch.dtype, kernel_mode: str = "kernel", wkv_chunk: int = 64,
    attn_q_chunk: Optional[int] = None, moe_group: int = 4096, ssm_chunk: int = 128,
    on_cache: Optional[CacheSink] = None, remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all layers in order; returns (x, the mean of the layers' aux
    losses, an fp32 scalar). ``remat`` checkpoints each layer when a
    gradient is to be taken (grad enabled, and ``x`` or a layer leaf
    requires grad) and no cache sink is given; otherwise it changes
    nothing."""
    kw = dict(kernel_mode=kernel_mode, wkv_chunk=wkv_chunk, attn_q_chunk=attn_q_chunk,
              moe_group=moe_group, ssm_chunk=ssm_chunk)
    total: Aux = 0.0
    if remat and on_cache is None and _needs_grad(layers, x):
        # the recompute may run on autograd's device thread: it runs under
        # the sharding context the forward ran under (models/moe.py reads it)
        ctx = current()
        for i in range(cfg.n_layers):

            def layer(h, i=i):
                with use_sharding(ctx):
                    return block_apply(layer_slice(layers, i, compute_dtype), cfg, h, positions,
                                       **kw)[:2]

            # the blocks draw no random numbers: no RNG state to keep
            x, aux = checkpoint(layer, x, use_reentrant=False, preserve_rng_state=False)
            total = total + aux
    else:
        for i in range(cfg.n_layers):
            p = layer_slice(layers, i, compute_dtype)
            x, aux, entries = block_apply(p, cfg, x, positions, **kw)
            total = total + aux
            if on_cache is not None:
                on_cache(i, entries)
    if not isinstance(total, torch.Tensor):  # no MoE layer
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return x, total / cfg.n_layers


def _needs_grad(layers: Params, x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in pytree.tree_leaves((layers, x))
    )


# ---------------------------------------------------------------------------
# Decode (one token, stateful)
# ---------------------------------------------------------------------------


def block_decode(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: Optional[torch.Tensor],
    cache: CacheEntries, pos: int, *, kernel_mode: str = "kernel",
) -> Tuple[torch.Tensor, CacheEntries]:
    """One token ``x`` (b, 1, d) through one block against this layer's
    cache entries. Returns ``(x_out, new entries)``: an attention block's
    K/V are written into ``cache``'s tensors in place and returned, with a
    hybrid block's new SSM state; an rwkv block returns new shift carries
    and wkv state."""
    if cfg.family == "ssm":
        h = rmsnorm(p["norm1"], x, cfg.norm_eps, kernel_mode=kernel_mode)
        out, (shift, state) = rwkv.tmix_apply(
            p["tmix"], cfg, h, kernel_mode=kernel_mode,
            shift_prev=cache["tmix_shift"], s0=cache["wkv"],
        )
        x = x + out
        h = rmsnorm(p["norm2"], x, cfg.norm_eps, kernel_mode=kernel_mode)
        out, cshift = rwkv.cmix_apply(p["cmix"], cfg, h, shift_prev=cache["cmix_shift"])
        return x + out, {"tmix_shift": shift, "cmix_shift": cshift, "wkv": state}
    h = rmsnorm(p["attn_norm"], x, cfg.norm_eps, kernel_mode=kernel_mode)
    attn_out, new = attention.attention_decode(
        p["attn"], cfg, h, positions, cache, pos, kernel_mode=kernel_mode
    )
    if cfg.family == "hybrid":
        ssm_out, state = ssm.ssm_decode(p["ssm"], cfg, h, {"conv": cache["conv"], "h": cache["h"]})
        attn_out = 0.5 * (attn_out + ssm_out)
        new = {**new, **state}
    x = x + attn_out
    h = rmsnorm(p["mlp_norm"], x, cfg.norm_eps, kernel_mode=kernel_mode)
    if cfg.is_moe:  # one group of the batch's tokens
        out, _ = moe.moe_apply(p["moe"], cfg, h, group_size=h.shape[0], capacity_factor=2.0)
    else:
        out = mlp_apply(p["mlp"], h, cfg.gated_act, cfg.d_ff)
    return x + out, new


def stack_decode(
    layers: Params, cfg: ArchConfig, x: torch.Tensor, positions: Optional[torch.Tensor],
    cache: Cache, pos: int, *, compute_dtype: torch.dtype, kernel_mode: str = "kernel",
    cache_mode: str = "carry",
) -> Tuple[torch.Tensor, Cache]:
    """All layers for one token. ``cache`` is stacked (a dict of
    ``(n_layers, ...)`` leaves) or a tuple of per-layer dicts; the new
    cache comes back in the same form. ``"carry"`` updates ``cache`` in
    place; ``"stream"`` copies each layer's entries into fresh leaves,
    updates those, and leaves ``cache`` untouched."""
    if cache_mode not in CACHE_MODES:
        raise ValueError(f"cache_mode must be one of {CACHE_MODES}, got {cache_mode!r}")
    stacked = isinstance(cache, dict)
    if not stacked and len(cache) != cfg.n_layers:
        raise ValueError(f"a per-layer cache needs {cfg.n_layers} layers, got {len(cache)}")
    fresh = lambda c: {n: torch.empty_like(t) for n, t in c.items()}  # noqa: E731
    if cache_mode == "carry":
        out = cache
    else:
        out = fresh(cache) if stacked else tuple(fresh(c) for c in cache)
    layer = lambda c, i: {n: t[i] for n, t in c.items()} if stacked else c[i]  # noqa: E731
    for i in range(cfg.n_layers):
        dst = layer(out, i)
        if cache_mode == "stream":
            for n, t in layer(cache, i).items():
                dst[n].copy_(t)
        p = layer_slice(layers, i, compute_dtype)
        x, new = block_decode(p, cfg, x, positions, dst, pos, kernel_mode=kernel_mode)
        for n, t in new.items():
            if t is not dst[n]:
                dst[n].copy_(t)
    return x, out
