"""Measured Salus memory profiles (the counterparts of the JAX package's
``profile_executable`` and ``profile_model``, which read an XLA
executable's memory analysis; PyTorch runs eagerly, so the port runs the
work once and reads the caching allocator's peak).

``profile_step`` runs a step and discards its output: right for a step
that returns new state and leaves its input alone (a service's handle, a
functional trainer). A step that updates its state in place would take a
hidden step there, so a training session's profile comes from
``profile_model``, which runs one loss-and-gradient pass and writes to no
parameter or optimizer state."""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.session import synchronize
from repro_torch.core.types import MemoryProfile


def tensor_bytes(tree: Any) -> int:
    """Bytes held by the tensors of a pytree."""
    return sum(
        t.numel() * t.element_size()
        for t in pytree.tree_leaves(tree)
        if isinstance(t, torch.Tensor)
    )


def profile_step(
    step_fn: Callable, state: Any, batch: Any, device: torch.device
) -> MemoryProfile:
    """Salus memory taxonomy of one step of ``step_fn`` on ``device``:

    * persistent <- bytes of the state tensors (params / optimizer state,
      live across iterations);
    * ephemeral  <- on CUDA, the caching allocator's peak over one step
      (``max_memory_allocated`` after ``reset_peak_memory_stats``) less
      what was allocated before the step. The CPU has no allocator peak:
      there the step still runs once and ephemeral is the bytes of the
      tensors it returns that are not part of ``state`` — a lower bound.
      Tests on the CPU pass explicit profiles instead.

    The step's output is discarded; ``state`` is not replaced."""
    device = torch.device(device)
    persistent = tensor_bytes(state)
    if device.type == "cuda":
        synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = step_fn(state, batch)
        synchronize(device)
        ephemeral = torch.cuda.max_memory_allocated(device) - base
        del out
    else:
        out = step_fn(state, batch)
        held = {
            t.data_ptr() for t in pytree.tree_leaves(state) if isinstance(t, torch.Tensor)
        }
        ephemeral = sum(
            t.numel() * t.element_size()
            for t in pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor) and t.data_ptr() not in held
        )
    return MemoryProfile(persistent=persistent, ephemeral=max(int(ephemeral), 1))


def profile_model(
    model: Any, params: Any, batch: Any, opt: Any = None, run: Any = None
) -> MemoryProfile:
    """The Salus profile of training ``model`` (or, with ``opt=None``, of
    evaluating its loss), measured without touching ``params`` or any
    optimizer state:

    * persistent <- bytes of ``params``, plus ``opt.state_bytes(params)``
      (m, v and the step, reckoned, not allocated) when ``opt`` is given;
    * ephemeral  <- on CUDA, the allocator's peak over one pass of the
      train step's loss and gradients (``make_grad_fn(model, run)``,
      microbatches and accumulator included), less what was allocated
      before, plus ``opt.update_temp_bytes(params)``; with ``opt=None``,
      the peak over the loss alone under ``torch.no_grad``. On the CPU,
      which has no allocator peak, the bytes of the gradients it returns
      plus the update's temporaries (a lower bound).

    The gradients are dropped; nothing is updated."""
    from repro_torch.train.train_step import make_grad_fn

    device = pytree.tree_leaves(params)[0].device
    persistent = tensor_bytes(params)
    if opt is not None:
        persistent += opt.state_bytes(params)
    grad_fn = make_grad_fn(model, run) if opt is not None else None

    def once():
        if grad_fn is None:
            with torch.no_grad():
                return model.loss(params, batch)
        return grad_fn(params, batch)

    if device.type == "cuda":
        synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        out = once()
        synchronize(device)
        ephemeral = torch.cuda.max_memory_allocated(device) - base
        del out
    else:
        out = once()
        ephemeral = tensor_bytes(out)
        del out
    if opt is not None:
        ephemeral += opt.update_temp_bytes(params)
    return MemoryProfile(persistent=persistent, ephemeral=max(int(ephemeral), 1))
