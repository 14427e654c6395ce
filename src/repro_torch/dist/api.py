"""Logical-axis sharding for the port (the JAX package's ``dist/api.py``).

A spec is the tuple of per-dim entries JAX puts in its ``PartitionSpec``:
``None`` (replicated), a mesh axis name, or a tuple of names. Model code
names *logical* axes (``"data"``, ``"model"``, ``"expert"``); a
:class:`ShardingContext` (built by :func:`repro_torch.dist.sharding.make_context`)
maps them onto the mesh's axes, and :func:`placements` turns a spec into
DTensor placements on a ``DeviceMesh``. With no active context every entry
point returns its input unchanged.

Guards applied before emitting a constraint (falling back to
replication for the offending dim):
  * the logical axis must map to a mesh axis that exists,
  * the dim size must divide the (product of the) mesh axis size(s),
  * the annotation arity must match the tensor rank.

A mesh here is a ``DeviceMesh`` or anything with ``.axis_names`` and a
``.shape`` mapping names to sizes (JAX's tests pass such fakes).

Tensor parallelism (JAX gets it from GSPMD at its ``constrain`` sites):
under a context whose ``DeviceMesh`` has a ``model`` axis of more than one
rank, the model code takes each param's local piece (``to_local()``) and
asks :func:`split_at`, with a JAX site's logical axes and the value's
whole shape, whether the guard splits it there. A split value is computed
as its local piece, and the :class:`ModelAxis` collectives join the
pieces where GSPMD would: ``copy`` where a value that every rank holds
whole enters a split computation (identity forward, all-reduce backward),
``reduce`` after a contraction over a split dim (all-reduce forward,
identity backward), ``gather`` where a split value meets a whole one
(all-gather forward, slice backward) and ``split`` for the converse
(slice forward, all-gather backward).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor
from torch.utils import _pytree as pytree

# A physical assignment for one logical axis: a mesh axis name, or a tuple
# of mesh axis names (e.g. data -> ("pod", "data") on multi-pod meshes).
Physical = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[Physical], ...]

_state = threading.local()


def mesh_axes(mesh) -> Dict[str, int]:
    """Mesh axis name -> size, in the mesh's axis order."""
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.shape))
    sizes = dict(mesh.shape)
    return {a: sizes[a] for a in mesh.axis_names}


def data_axes(mesh) -> List[int]:
    """Indices of ``mesh``'s axes that split the batch (``pod``, ``data``)."""
    return [i for i, name in enumerate(mesh_axes(mesh)) if name in ("pod", "data")]


def _axes_size(mesh_shape: Dict[str, int], phys: Optional[Physical]) -> int:
    if phys is None:
        return 1
    if isinstance(phys, tuple):
        n = 1
        for a in phys:
            n *= mesh_shape.get(a, 0)
        return n
    return mesh_shape.get(phys, 0)


def guarded_entries(
    axes: Sequence[Optional[str]],
    shape: Sequence[int],
    phys_map: Dict[str, Physical],
    mesh_shape: Dict[str, int],
) -> list:
    """Map logical axes to physical per dim, replicating any dim whose
    axis is absent, trivial (size 1), or does not divide the dim size.
    The single guard shared by activation constraints and the parameter/
    cache sharding rules."""
    entries = []
    for dim, ax in zip(shape, axes):
        phys = phys_map.get(ax) if ax is not None else None
        size = _axes_size(mesh_shape, phys)
        if phys is None or size <= 1 or dim % size != 0:
            entries.append(None)
        else:
            entries.append(phys)
    return entries


def placements(spec: Spec, mesh) -> List[Placement]:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh axis: a
    tensor dim sharded over several mesh axes puts ``Shard(d)`` on each of
    them (DTensor nests them in mesh-axis order, as JAX does a tuple
    entry's names); every other mesh axis replicates."""
    out: List[Placement] = []
    for name in mesh_axes(mesh):
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def place(tree, shardings):
    """Each tensor of ``tree`` as a ``DTensor`` laid out by its
    ``(DeviceMesh, placements)`` pair in ``shardings`` (the port's
    ``jax.device_put`` with shardings). Every rank passes the same full
    values (read from one checkpoint, or drawn from one seed) and keeps
    its own piece: no communication."""
    flat, spec = pytree.tree_flatten(tree)
    layouts = pytree.tree_leaves(shardings, is_leaf=is_layout)
    if len(layouts) != len(flat):
        raise ValueError(f"{len(flat)} leaves but {len(layouts)} layouts")
    out = [distribute_tensor(t.to(mesh.device_type), mesh, pl, src_data_rank=None)
           for t, (mesh, pl) in zip(flat, layouts)]
    return pytree.tree_unflatten(out, spec)


def is_layout(x) -> bool:
    """A ``(DeviceMesh, placements)`` pair: a leaf of a shardings tree."""
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh)


@dataclass(frozen=True)
class ShardingContext:
    """Mesh + logical->physical axis mapping + global sharding policy."""

    mesh: Any
    axis_map: Dict[str, Physical] = field(default_factory=dict)
    zero3: bool = False

    def spec_for(self, axes: Sequence[Optional[str]], shape: Sequence[int]) -> Optional[Spec]:
        """Logical annotation -> spec, or None (skip constraint)."""
        if len(axes) != len(shape):
            return None  # annotation written for a different layout variant
        entries = guarded_entries(axes, shape, self.axis_map, mesh_axes(self.mesh))
        if all(e is None for e in entries):
            return None
        return tuple(entries)


def current() -> Optional[ShardingContext]:
    """The active context installed by :func:`use_sharding`, or None."""
    return getattr(_state, "ctx", None)


@contextlib.contextmanager
def use_sharding(ctx: Optional[ShardingContext]):
    """Install ``ctx`` as the active sharding context for this thread."""
    prev = current()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


class ModelAxis(NamedTuple):
    """The active mesh's ``model`` axis: its process group, this rank's
    index on it and its size. The collectives are autograd functions
    (module docstring) on dim ``dim`` of ``x``; a split takes this rank's
    ``1 / size`` of the dim. ``WHOLE``, of size 1, stands for a value no
    rank splits: its collectives return ``x`` itself."""

    group: Any
    rank: int
    size: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x, "copy")

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return self.run(x, "reduce")

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return self.run(x, "gather", dim)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return self.run(x, "split", dim)

    def run(self, x: torch.Tensor, kind: str, dim: int = -1) -> torch.Tensor:
        return x if self.size == 1 else _Collective.apply(x, self, kind, dim)


WHOLE = ModelAxis(None, 0, 1)
# each collective's backward is its dual's forward
_DUAL = {"copy": "reduce", "reduce": "copy", "gather": "split", "split": "gather"}


def _collective(x: torch.Tensor, ax: ModelAxis, kind: str, dim: int) -> torch.Tensor:
    if kind == "copy":
        return x
    if kind == "split":
        n = x.shape[dim] // ax.size
        return x.narrow(dim, ax.rank * n, n).contiguous()
    x = x.contiguous()
    if kind == "reduce":
        x = x.clone()
        dist.all_reduce(x, group=ax.group)
        return x
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim)


class _Collective(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, kind, dim):
        ctx.dual = ax, _DUAL[kind], dim
        out = _collective(x, ax, kind, dim)
        return out.view_as(out) if out is x else out

    @staticmethod
    def backward(ctx, grad):
        return _collective(grad, *ctx.dual), None, None, None


def model_axis() -> ModelAxis:
    """The active context's model axis, or ``WHOLE``: no context, a mesh
    that is not a ``DeviceMesh``, no ``model`` axis, or one of one rank."""
    mesh = getattr(current(), "mesh", None)
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if not isinstance(mesh, DeviceMesh) or "model" not in names:
        return WHOLE
    i = names.index("model")
    return ModelAxis(mesh.get_group(i), mesh.get_local_rank(i), mesh.size(i))


def split_at(axes: Sequence[Optional[str]], shape: Sequence[int]) -> ModelAxis:
    """The model axis if the active context splits a value of whole
    ``shape`` on it where ``axes`` name ``model`` (or ``expert``): the
    guard of JAX's ``constrain`` at that site. ``WHOLE``: the value stays
    whole on every rank."""
    ax = model_axis()
    if ax.size == 1:
        return WHOLE
    spec = current().spec_for(tuple(axes), tuple(shape))
    return ax if spec is not None and "model" in spec else WHOLE


def _constrain(x, axes):
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    spec = ctx.spec_for(tuple(axes), x.shape)
    if spec is None:
        return x
    return x.redistribute(ctx.mesh, placements(spec, ctx.mesh))


def constrain(x: torch.Tensor, axes: Sequence[Optional[str]]):
    """Lay a ``DTensor`` activation out by logical ``axes``. The input
    itself without a context or for a plain tensor."""
    return _constrain(x, axes)


def constrain_weight(w: torch.Tensor, axes: Sequence[Optional[str]]):
    """Lay a weight out at its point of use.

    Separate from :func:`constrain` so weight policy can diverge from
    activation policy: under ZeRO-3 the *storage* layout carries an extra
    data-axis shard, and this use-point constraint gathers it."""
    return _constrain(w, axes)
