"""Train-step factory: loss + grad (+ microbatch accumulation) + optimizer
(the JAX package's ``train/train_step.py``).

``make_train_step(model, opt, run)`` returns ``(params, opt_state, batch)
-> (params, opt_state, metrics)``. The step reads params and optimizer
state only from its arguments and updates them in place (``AdamW.update``);
the trees it returns are the ones it was given. Microbatch ``j`` takes rows
``j, n + j, 2n + j, ...`` of the batch, and gradients accumulate in
``run.accum_dtype``.

Gradients are taken with ``torch.autograd.grad`` with respect to per-layer
views of the stacked ``(n_layers, ...)`` leaves, so each layer's gradient
arrives on its own and is added into its slice of the accumulator, never
as a zero-padded copy of the whole stack.

On a mesh (JAX's GSPMD step): params and AdamW state are ``DTensor``s laid
out by the sharding rules, and the batch's rows are split over the data
axes (``dist.sharding.batch_shardings``). The step runs under the active
sharding context, or the mesh's own (``dist.sharding.make_context``) if
none is. Each rank computes with its
model pieces of the params (``to_local()``; a ZeRO-3 leaf is first
gathered over the data axes only, never over the model axis), and the
model code splits its work on the model axis where the guard lets it,
with the collectives GSPMD would insert (``dist.api``): tensor-parallel
attention, MLP, SSM and rwkv heads, expert-parallel MoE, vocab-parallel
embedding and loss. So a rank's gradient of a model piece is already
that piece's, and only the mean over the data axes remains (ranks that
differ only in their model index saw the same rows); a ZeRO-3 leaf's is
then cut to its data shard. AdamW updates the local shards, clipping by
the global fp32 norm (a sharded leaf's squares summed over the axes it is
sharded on, a replicated leaf counted once). On a one-device mesh this is
the single-device step, bit for bit. The MoE layer takes JAX's global
semantics over the ranks' rows (its groups, capacity drops and aux loss
are the global microbatch's, ``models/moe.py``), reading the data ranks
from the sharding context, so the data mean of the ranks' losses and
gradients is the GSPMD step's.
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.dist.api import current, data_axes, is_layout, use_sharding
from repro_torch.dist.sharding import make_context
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, norm_of_squares, sum_of_squares


@dataclass(frozen=True)
class TrainRunConfig:
    num_microbatches: int = 1
    accum_dtype: str = "float32"
    grad_transform: Optional[Callable] = None  # e.g. compression hook
    # JAX's accumulator layout: a (DeviceMesh, placements) tree mirroring
    # the params whose data axes replicate. Accepted and checked for the JAX
    # API; it changes nothing here, where a rank accumulates the gradients
    # of its params' model pieces locally, which is that layout.
    grad_accum_shardings: Optional[Any] = None


def _split_microbatches(batch: Dict, n: int) -> Dict:
    """(b, ...) -> (n, b/n, ...) on every leaf; microbatch j takes rows
    {j, n+j, 2n+j, ...} (the JAX package's strided grouping)."""

    def split(t):
        b = t.shape[0]
        if b % n:
            raise ValueError(f"batch {b} not divisible by microbatches {n}")
        return t.reshape(b // n, n, *t.shape[1:]).transpose(0, 1)

    return pytree.tree_map(split, batch)


def _grad_inputs(params: Dict) -> Dict:
    """A tree over the same storage whose leaves are fresh autograd leaves:
    ``layers`` leaves become tuples of per-layer views."""
    leaf = lambda t: t.detach().requires_grad_()
    per_layer = lambda t: tuple(leaf(x) for x in t.unbind(0))
    return {
        k: pytree.tree_map(per_layer if k == "layers" else leaf, v) for k, v in params.items()
    }


def value_and_grad(model: Model, params: Dict, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """``(loss, grads)`` of ``model.loss``; each ``layers`` gradient is a
    tuple of per-layer tensors (``stack_grads`` makes them leaves)."""
    gp = _grad_inputs(params)
    inputs, spec = pytree.tree_flatten(gp)
    loss = model.loss(gp, batch)
    grads = torch.autograd.grad(loss, inputs, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]
    return loss.detach(), pytree.tree_unflatten(grads, spec)


def stack_grads(grads: Dict) -> Dict:
    """Per-layer gradient tuples -> stacked ``(n_layers, ...)`` leaves."""
    is_tuple = lambda x: isinstance(x, tuple)
    return {
        k: pytree.tree_map(torch.stack, v, is_leaf=is_tuple) if k == "layers" else v
        for k, v in grads.items()
    }


def make_grad_fn(model: Model, run: Optional[TrainRunConfig] = None) -> Callable:
    """``(params, batch) -> (loss, grads)`` with ``run``'s microbatching:
    the mean loss and gradient over the microbatches, the gradient summed
    in ``accum_dtype`` (as the JAX step's ``(a + g.astype(adt))``) and
    scaled by ``1 / n``. On a mesh (``DTensor`` params) the loss is the
    mean over the data axes and each gradient is this rank's piece under
    its param's placements (module docstring)."""
    run = run or TrainRunConfig()
    _check_accum_layouts(run.grad_accum_shardings)

    def local_grad_fn(params, batch):
        n = run.num_microbatches
        if n <= 1:
            loss, grads = value_and_grad(model, params, batch)
            return loss, stack_grads(grads)
        adt = getattr(torch, run.accum_dtype)
        mbs = _split_microbatches(batch, n)
        acc = pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
        loss_sum = torch.zeros((), dtype=torch.float32, device=pytree.tree_leaves(params)[0].device)
        for j in range(n):
            mb = pytree.tree_map(lambda t: t[j], mbs)
            loss, grads = value_and_grad(model, params, mb)
            loss_sum = loss_sum + loss
            _accumulate(acc, grads)
            del grads
        inv = 1.0 / n
        for a in pytree.tree_leaves(acc):
            a.mul_(inv)
        return loss_sum * inv, acc

    def grad_fn(params, batch):
        if not is_sharded(params):
            return local_grad_fn(params, batch)
        with on_mesh(params, model):
            return _mesh_grads(local_grad_fn, params, batch)

    return grad_fn


def is_sharded(params) -> bool:
    """Whether ``params`` live on a mesh (``DTensor`` leaves)."""
    return any(isinstance(t, DTensor) for t in pytree.tree_leaves(params))


def on_mesh(params, model: Model):
    """Where ``params`` are on a mesh, the active sharding context, or else
    the mesh's own (``dist.sharding.make_context``), installed: the model
    code splits its work on the model axis of the context it runs under."""
    if not is_sharded(params):
        return contextlib.nullcontext()
    return use_sharding(current() or make_context(_mesh_of(params), model.cfg))


def local_pieces(tree):
    """Each ``DTensor`` leaf as this rank's piece; other leaves as they are."""
    return pytree.tree_map(lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)


def _check_accum_layouts(tree) -> None:
    if tree is None:
        return
    for lay in pytree.tree_leaves(tree, is_leaf=is_layout):
        if not is_layout(lay) or any(isinstance(lay[1][i], Shard) for i in data_axes(lay[0])):
            raise ValueError("grad_accum_shardings: a tree of (DeviceMesh, placements) pairs "
                             "whose data axes replicate")


def _mesh_of(params):
    leaves = pytree.tree_leaves(params)
    if not all(isinstance(t, DTensor) for t in leaves):
        raise ValueError("on a mesh every param leaf is a DTensor")
    return leaves[0].device_mesh


def _batch_rows(t):
    if not isinstance(t, DTensor):
        raise ValueError("on a mesh the batch's leaves are DTensors (dist.sharding.batch_shardings)")
    return t.to_local()


def _cut(t: torch.Tensor, mesh, src, dst) -> torch.Tensor:
    """This rank's piece, under ``dst``, of a value it holds under ``src``
    (``dst`` only shards further: no communication)."""
    return DTensor.from_local(t, mesh, src, run_check=False).redistribute(mesh, dst).to_local()


def _mean_over_data(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of ``t`` over the ranks of the mesh's data axes, in place."""
    axes = [i for i in data_axes(mesh) if mesh.size(i) > 1]
    for i in axes:
        dist.all_reduce(t, group=mesh.get_group(i))
    n = math.prod(mesh.size(i) for i in axes)
    return t.div_(n) if n > 1 else t


def _model_placements(p: DTensor) -> list:
    """``p``'s placements with the data axes replicated: the layout the
    step computes with."""
    data = set(data_axes(p.device_mesh))
    return [Replicate() if i in data else pl for i, pl in enumerate(p.placements)]


@torch.no_grad()
def _reduce_grads(grads, params, mesh) -> list:
    """Each rank's piece of the data-axis mean of the gradients of its
    params' model pieces, cut to the params' placements."""
    return [_cut(_mean_over_data(g.contiguous(), mesh), mesh, _model_placements(p), p.placements)
            for g, p in zip(pytree.tree_leaves(grads), pytree.tree_leaves(params))]


def _model_piece(p: DTensor) -> torch.Tensor:
    pl = _model_placements(p)
    return (p if tuple(pl) == tuple(p.placements) else p.redistribute(p.device_mesh, pl)).to_local()


def _mesh_grads(local_grad_fn, params, batch):
    """``(loss, grads)`` on a mesh: the loss averaged over the data axes,
    the gradients as each rank's pieces under its params' placements."""
    mesh = _mesh_of(params)
    loss, grads = local_grad_fn(pytree.tree_map(_model_piece, params),
                                pytree.tree_map(_batch_rows, batch))
    _, spec = pytree.tree_flatten(params)
    pieces = _reduce_grads(grads, params, mesh)
    return _mean_over_data(loss.clone(), mesh), pytree.tree_unflatten(pieces, spec)


@torch.no_grad()
def sharded_global_norm(grads, params) -> torch.Tensor:
    """The global fp32 norm of gradients held as pieces laid out like
    ``params`` (``DTensor``s): each leaf's squares summed over the mesh
    axes it is sharded on; a replicated leaf counted once."""
    flat_p = pytree.tree_leaves(params)
    mesh = flat_p[0].device_mesh
    sq = torch.stack([sum_of_squares(g) for g in pytree.tree_leaves(grads)])
    for i in range(mesh.ndim):
        mask = torch.tensor([isinstance(p.placements[i], Shard) for p in flat_p], device=sq.device)
        if mesh.size(i) > 1 and bool(mask.any()):
            part = sq * mask
            dist.all_reduce(part, group=mesh.get_group(i))
            sq = torch.where(mask, part, sq)
    return norm_of_squares(sq.unbind(0))


@torch.no_grad()
def _accumulate(acc: Dict, grads: Dict) -> None:
    for name, g in grads.items():
        if name == "layers":
            for a, gl in zip(pytree.tree_leaves(acc["layers"]),
                             pytree.tree_leaves(g, is_leaf=lambda x: isinstance(x, tuple))):
                for i, gi in enumerate(gl):
                    a[i].add_(gi.to(a.dtype))
        else:
            for a, gi in zip(pytree.tree_leaves(acc[name]), pytree.tree_leaves(g)):
                a.add_(gi.to(a.dtype))


def make_train_step(model: Model, opt: AdamW, run: Optional[TrainRunConfig] = None):
    run = run or TrainRunConfig()
    grad_fn = make_grad_fn(model, run)

    def train_step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        if run.grad_transform is not None:
            grads = run.grad_transform(grads)
        if is_sharded(params):  # AdamW on the local shards, in place
            _, _, metrics = opt.update(grads, local_pieces(opt_state), local_pieces(params),
                                       grad_norm=sharded_global_norm(grads, params))
        else:
            params, opt_state, metrics = opt.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step


def make_eval_step(model: Model):
    @torch.no_grad()
    def eval_step(params, batch):
        return model.loss(params, batch)

    return eval_step
