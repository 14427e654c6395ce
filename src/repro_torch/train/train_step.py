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
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.models.model import Model
from repro_torch.train.optimizer import AdamW


@dataclass(frozen=True)
class TrainRunConfig:
    num_microbatches: int = 1
    accum_dtype: str = "float32"
    grad_transform: Optional[Callable] = None  # e.g. compression hook
    # the JAX package's sharding constraint on the accumulator; one GPU has
    # no mesh, so anything but None is refused
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
    scaled by ``1 / n``."""
    run = run or TrainRunConfig()
    if run.grad_accum_shardings is not None:
        raise ValueError("grad_accum_shardings: the port runs on one GPU, with no mesh")

    def grad_fn(params, batch):
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

    return grad_fn


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
