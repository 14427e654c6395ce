"""Sharding rules: parameter path patterns -> logical axes, plus the
batch/cache sharding builders (the JAX package's ``dist/sharding.py``).

The rule table speaks *logical* axes:
  * ``model``  — tensor-parallel axis (d_ff, q_dim, vocab, d_inner),
  * ``expert`` — MoE expert-parallel axis (mapped onto ``model``),
  * ``data``   — batch / FSDP axis (``("pod", "data")`` on multi-pod).

Every named dim is guarded: if the dim does not divide the mesh axis
size (or the axis is absent), that dim falls back to replication, so the
same rules drive the 16x16 production mesh, the 4x2 test mesh, and the
1x1 single-device mesh.

``param_spec`` returns the spec (JAX's ``PartitionSpec`` entries as a
tuple); the ``*_shardings`` builders return a ``(mesh, placements)`` pair
a leaf, the placements from :func:`repro_torch.dist.api.placements`.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import Placement
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ArchConfig, ShapeConfig, batch_spec
from repro_torch.dist.api import (
    Physical,
    ShardingContext,
    Spec,
    _axes_size,
    current,
    mesh_axes,
    placements,
)
from repro_torch.dist.api import guarded_entries as _guarded

Layout = Tuple[Any, List[Placement]]

# ---------------------------------------------------------------------------
# Parameter rules
# ---------------------------------------------------------------------------

# (path regex, per-dim logical axes). Matched with ``re.search`` against the
# "/"-joined tree path, so optimizer-state prefixes ("m/...", "v/...") hit
# the same rules as the raw params. First match whose arity equals the leaf
# rank wins; everything unmatched is replicated.
#
# Stacked layer leaves carry a leading n_layers axis -> leading ``None``.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    # embeddings / head: vocab-sharded over the TP axis
    (r"embed/table$", ("model", None)),
    (r"lm_head/table$", ("model", None)),
    # attention: QKV column-parallel, output row-parallel
    (r"layers/attn/w[qkv]$", (None, None, "model")),
    (r"layers/attn/wo$", (None, "model", None)),
    (r"layers/attn/b[qkv]$", (None, "model")),
    # dense MLP (SwiGLU/GeGLU): gate/up column-parallel, down row-parallel
    (r"layers/mlp/w_(gate|up)$", (None, None, "model")),
    (r"layers/mlp/w_down$", (None, "model", None)),
    # MoE: experts sharded over the expert(=model) axis; router replicated
    (r"layers/moe/w_(gate|up|down)$", (None, "expert", None, None)),
    # mamba branch (hybrid): inner dim is the TP axis
    (r"layers/ssm/in_proj$", (None, None, "model")),
    (r"layers/ssm/out_proj$", (None, "model", None)),
    (r"layers/ssm/x_proj$", (None, "model", None)),
    (r"layers/ssm/dt_proj$", (None, None, "model")),
    (r"layers/ssm/a_log$", (None, "model", None)),
    (r"layers/ssm/conv_w$", (None, None, "model")),
    (r"layers/ssm/(conv_b|dt_bias|d_skip)$", (None, "model")),
    # rwkv6 time-mix / channel-mix: square projections column-parallel,
    # output row-parallel; loras/mixing vectors replicated (tiny)
    (r"layers/tmix/w[rkvg]$", (None, None, "model")),
    (r"layers/tmix/wo$", (None, "model", None)),
    (r"layers/tmix/mix_w1$", (None, None, "model")),
    (r"layers/cmix/wk$", (None, None, "model")),
    (r"layers/cmix/wv$", (None, "model", None)),
    (r"layers/cmix/wr$", (None, None, "model")),
)

# Decode/recurrent cache leaves, keyed by leaf name. Dim 1 is the batch
# (data) axis; KV-head / inner dims take the TP axis where they divide.
_CACHE_RULES: Dict[str, Tuple[Optional[str], ...]] = {
    "k": (None, "data", None, "model", None),
    "v": (None, "data", None, "model", None),
    "k_scale": (None, "data", None, "model"),
    "v_scale": (None, "data", None, "model"),
    "conv": (None, "data", None, "model"),
    "h": (None, "data", "model", None),
    "wkv": (None, "data", "model", None, None),
    "tmix_shift": (None, "data", None, None),
    "cmix_shift": (None, "data", None, None),
}


def _physical_axes(mesh) -> Dict[str, Physical]:
    """Logical -> physical axis map for ``mesh`` (works on fakes too)."""
    names = tuple(mesh_axes(mesh))
    out: Dict[str, Physical] = {}
    if "model" in names:
        out["model"] = "model"
        out["expert"] = "model"
    if "data" in names:
        out["data"] = ("pod", "data") if "pod" in names else "data"
    return out


def _path_str(path: Sequence[Any]) -> str:
    return "/".join(
        str(getattr(p, "key", getattr(p, "idx", p))) for p in path
    )


def param_spec(
    path: Sequence[Any],
    shape: Sequence[int],
    arch: ArchConfig,
    mesh,
    *,
    zero3: bool = False,
) -> Spec:
    """The spec of one parameter leaf.

    ``path`` is a pytree key path (``MappingKey``/``SequenceKey``
    entries) or plain strings. Dims that do not divide their mesh axis
    fall back to replication; unmatched paths are fully replicated.
    """
    key = _path_str(path)
    phys_map = _physical_axes(mesh)
    mesh_shape = mesh_axes(mesh)
    entries = [None] * len(shape)
    for pat, axes in _PARAM_RULES:
        if len(axes) == len(shape) and re.search(pat, key):
            entries = _guarded(axes, shape, phys_map, mesh_shape)
            break
    if zero3:
        entries = _add_zero3(entries, shape, key, phys_map, mesh_shape)
    return tuple(entries)


def _add_zero3(entries, shape, key, phys_map, mesh_shape):
    """ZeRO-3/FSDP: additionally shard the largest still-replicated dim
    along the data axis. The stacked-layer leading axis is skipped (the
    layer loop slices it every step)."""
    data = phys_map.get("data")
    size = _axes_size(mesh_shape, data)
    if data is None or size <= 1:
        return entries
    skip_leading = "layers/" in key
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if i == 0 and skip_leading:
            continue
        if entries[i] is None and shape[i] % size == 0 and shape[i] >= size:
            entries = list(entries)
            entries[i] = data
            break
    return entries


def param_shardings(
    params,
    cfg: ArchConfig,
    mesh,
    *,
    serve: bool = False,
    zero3: Optional[bool] = None,
):
    """A ``(mesh, placements)`` tree mirroring ``params`` (works on the
    optimizer state too — its m/v subtrees repeat the param paths).

    ``zero3`` defaults to the active sharding context's setting; serving
    never uses ZeRO-3 (no optimizer to amortize the gathers against).
    """
    if zero3 is None:
        ctx = current()
        zero3 = bool(ctx is not None and ctx.zero3)
    if serve:
        zero3 = False

    def one(path, leaf):
        spec = param_spec(tuple(path), leaf.shape, cfg, mesh, zero3=zero3)
        return mesh, placements(spec, mesh)

    return pytree.tree_map_with_path(one, params)


def batch_shardings(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict[str, Layout]:
    """Input-batch layouts: leading (batch) dim over the data axis."""
    phys_map = _physical_axes(mesh)
    data = phys_map.get("data")
    size = _axes_size(mesh_axes(mesh), data)
    out: Dict[str, Layout] = {}
    for k, (shp, _dtype) in batch_spec(cfg, shape).items():
        lead = data if (shp and size > 1 and shp[0] % size == 0) else None
        out[k] = mesh, placements((lead,) + (None,) * (len(shp) - 1), mesh)
    return out


def cache_shardings(cache, cfg: ArchConfig, shape: ShapeConfig, mesh):
    """Decode-state layouts. Handles both the stacked layout (leading
    n_layers axis) and per-layer slices (rule minus the leading entry)."""
    phys_map = _physical_axes(mesh)
    mesh_shape = mesh_axes(mesh)

    def one(path, leaf):
        name = _path_str(path).split("/")[-1]
        rule = _CACHE_RULES.get(name)
        ndim = len(leaf.shape)
        if rule is not None and len(rule) == ndim + 1:
            rule = rule[1:]  # per-layer (unstacked) slice
        if rule is None or len(rule) != ndim:
            return mesh, placements((None,) * ndim, mesh)
        return mesh, placements(tuple(_guarded(rule, leaf.shape, phys_map, mesh_shape)), mesh)

    return pytree.tree_map_with_path(one, cache)


def replicated(mesh) -> Layout:
    """The fully replicated layout on ``mesh`` (scalars, metrics)."""
    return mesh, placements((), mesh)


def make_context(mesh, cfg: ArchConfig, *, zero3: bool = False) -> ShardingContext:
    """Build the ShardingContext installed via ``use_sharding``."""
    return ShardingContext(mesh=mesh, axis_map=_physical_axes(mesh), zero3=zero3)
