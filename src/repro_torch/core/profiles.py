"""Measured Salus memory profiles of a live step (the counterpart of the
JAX package's ``profile_executable``, which reads an XLA executable's
memory analysis; PyTorch runs eagerly, so the port runs one step)."""
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
