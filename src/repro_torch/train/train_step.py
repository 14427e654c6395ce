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
axes (``dist.sharding.batch_shardings``). The kernels take plain tensors,
so every rank gathers each param whole (``full_tensor()``), takes the loss
and gradients of its own rows, cuts each gradient to its param's model
slice, and averages that slice over the data axes only (ranks that differ
only in their model index saw the same rows); each rank keeps the piece
its placements hold, and AdamW updates
the local shards, clipping by the global fp32 norm (a sharded leaf's
squares summed over the axes it is sharded on, a replicated leaf counted
once). On a one-device mesh this is the single-device step, bit for bit.
A loss term over a call's rows, such as the MoE aux loss, is taken over
each rank's microbatch, as a data-parallel step takes it (JAX's GSPMD step
takes it over the global microbatch). The model axis holds shards but does
no split work yet (tensor-parallel compute is not ported).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils import _pytree as pytree

from repro_torch.dist.api import data_axes, is_layout
from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW, norm_of_squares, sum_of_squares


@dataclass(frozen=True)
class TrainRunConfig:
    num_microbatches: int = 1
    accum_dtype: str = "float32"
    grad_transform: Optional[Callable] = None  # e.g. compression hook
    # JAX's accumulator layout: a (DeviceMesh, placements) tree mirroring
    # the params whose data axes replicate. Accepted and checked for the JAX
    # API; it changes nothing here, where a rank accumulates its whole
    # gradient locally and always reduces only its params' model slice.
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
        return _mesh_grads(local_grad_fn, params, batch)

    return grad_fn


def is_sharded(params) -> bool:
    """Whether ``params`` live on a mesh (``DTensor`` leaves)."""
    return any(isinstance(t, DTensor) for t in pytree.tree_leaves(params))


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


@torch.no_grad()
def _reduce_grads(grads, params, mesh) -> list:
    """Each rank's piece of the data-axis mean: a whole local gradient is
    first cut to its param's model slice (the param's placements with the
    data axes replicated), so the reduction moves only that slice."""
    whole = [Replicate()] * mesh.ndim
    data = set(data_axes(mesh))
    out = []
    for g, p in zip(pytree.tree_leaves(grads), pytree.tree_leaves(params)):
        model = [Replicate() if i in data else pl for i, pl in enumerate(p.placements)]
        g = _mean_over_data(_cut(g, mesh, whole, model).contiguous(), mesh)
        out.append(_cut(g, mesh, model, p.placements))
    return out


def _mesh_grads(local_grad_fn, params, batch):
    """``(loss, grads)`` on a mesh: the loss averaged over the data axes,
    the gradients as each rank's pieces under its params' placements."""
    mesh = _mesh_of(params)
    full = pytree.tree_map(lambda t: t.full_tensor(), params)  # every rank gathers
    loss, grads = local_grad_fn(full, pytree.tree_map(_batch_rows, batch))
    del full
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
            local = lambda tree: pytree.tree_map(
                lambda t: t.to_local() if isinstance(t, DTensor) else t, tree)
            _, _, metrics = opt.update(grads, local(opt_state), local(params),
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
