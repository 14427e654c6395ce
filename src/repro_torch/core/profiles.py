"""Workload memory/time profiles (the port's copy of the JAX package's
``core/profiles.py``). Two sources:

1. ``PAPER_WORKLOADS`` — the paper's 15-model workload collection (Table 3)
   with per-batch-size persistent/ephemeral(P100 peak)/iteration-time/
   utilization figures, ``paper_profile``, ``paper_job`` and
   ``inference_profile``: the tables that drive the trace-scale simulator
   (``tracegen``), identical to the JAX package's.

2. Measured profiles. The JAX package's ``profile_executable`` reads an
   XLA executable's ``memory_analysis()`` and has no counterpart here:
   PyTorch runs eagerly, so ``profile_step`` and ``profile_model`` run the
   work once and read the caching allocator's peak.

``profile_step`` runs a step and discards its output: right for a step
that returns new state and leaves its input alone (a service's handle, a
functional trainer). A step that updates its state in place would take a
hidden step there, so a training session's profile comes from
``profile_model``, which runs one loss-and-gradient pass and writes to no
parameter or optimizer state."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.session import synchronize
from repro_torch.core.types import GB, MB, JobSpec, MemoryProfile

# name: (persistent MB, ephemeral peak MB, iter_time s, utilization)
# Ephemeral figures follow Fig. 1's peak ordering; iteration times follow
# the paper's "tens of ms to a few seconds" (§3.2.2) scaled by model size;
# utilization reflects §5.2 (resnet-class compute-bound, superres/vae low).
PAPER_WORKLOADS: Dict[str, Tuple[float, float, float, float]] = {
    "alexnet_25": (191, 1586, 0.042, 0.68),
    "alexnet_50": (204, 2254, 0.059, 0.75),
    "alexnet_100": (229, 3597, 0.092, 0.80),
    "googlenet_25": (111, 3305, 0.085, 0.82),
    "googlenet_50": (125, 4898, 0.131, 0.86),
    "googlenet_100": (153, 8067, 0.222, 0.90),
    "inception3_25": (247, 5308, 0.225, 0.90),
    "inception3_50": (271, 7911, 0.392, 0.93),
    "inception3_100": (319, 13101, 0.711, 0.95),
    "inception4_25": (413, 7857, 0.391, 0.93),
    "inception4_50": (438, 11509, 0.681, 0.95),
    "inception4_75": (462, 13813, 0.944, 0.96),
    "overfeat_25": (311, 2202, 0.049, 0.70),
    "overfeat_50": (330, 3298, 0.071, 0.76),
    "overfeat_100": (364, 5533, 0.112, 0.82),
    "resnet50_25": (326, 5087, 0.186, 0.91),
    "resnet50_50": (350, 7812, 0.333, 0.94),
    "resnet50_75": (373, 10434, 0.465, 0.95),
    "resnet101_25": (531, 7230, 0.297, 0.93),
    "resnet101_50": (555, 11042, 0.533, 0.95),
    "resnet101_75": (579, 13748, 0.749, 0.96),
    "resnet152_25": (740, 9115, 0.419, 0.94),
    "resnet152_50": (772, 13295, 0.752, 0.96),
    "resnet152_75": (822, 13800, 0.991, 0.96),
    "vgg11_25": (640, 3269, 0.076, 0.80),
    "vgg11_50": (661, 4867, 0.121, 0.85),
    "vgg11_100": (705, 8063, 0.203, 0.89),
    "vgg16_25": (745, 4116, 0.119, 0.86),
    "vgg16_50": (767, 6139, 0.197, 0.90),
    "vgg16_100": (811, 10186, 0.343, 0.93),
    "vgg19_25": (847, 4516, 0.141, 0.87),
    "vgg19_50": (869, 6744, 0.232, 0.91),
    "vgg19_100": (914, 11196, 0.407, 0.94),
    "vae_64": (22, 35, 0.004, 0.08),
    "vae_128": (24, 46, 0.006, 0.10),
    "vae_256": (28, 68, 0.009, 0.12),
    "superres_32": (39, 333, 0.020, 0.22),
    "superres_64": (44, 575, 0.033, 0.26),
    "superres_128": (53, 1058, 0.058, 0.30),
    "speech_25": (305, 2916, 0.172, 0.72),
    "speech_50": (329, 4912, 0.298, 0.78),
    "speech_75": (352, 6804, 0.422, 0.82),
    "seq2seq_small": (122, 1568, 0.065, 0.45),
    "seq2seq_medium": (372, 4091, 0.168, 0.62),
    "seq2seq_large": (964, 8172, 0.349, 0.74),
}

P100_CAPACITY = 16 * GB


def paper_profile(name: str) -> MemoryProfile:
    p, e, _, _ = PAPER_WORKLOADS[name]
    return MemoryProfile(persistent=int(p * MB), ephemeral=int(e * MB))


def paper_job(
    name: str,
    n_iters: int,
    arrival_time: float = 0.0,
    kind: str = "train",
) -> JobSpec:
    p, e, t, u = PAPER_WORKLOADS[name]
    return JobSpec(
        name=name,
        profile=MemoryProfile(int(p * MB), int(e * MB)),
        n_iters=n_iters,
        iter_time=t,
        utilization=u,
        arrival_time=arrival_time,
        kind=kind,
    )


def inference_profile(name: str) -> Tuple[MemoryProfile, float]:
    """Inference variant of a workload.

    persistent: model weights only — the training-table persistent figure
    includes framework/optimizer buffers, so take ~50% (e.g. resnet152:
    822 MB training-persistent vs ~240 MB fp32 weights + runtime);
    ephemeral: single-request forward activations, ~1/40 of the batched
    fwd+bwd *training* peak (no backward, batch 1 vs 25-100; e.g.
    resnet152 batch-1 forward ~ 350 MB vs 13.8 GB training peak),
    floor 16 MB; iteration: one request ~ forward only ~ iter/3.
    Returns (profile, request_latency)."""
    p, e, t, _ = PAPER_WORKLOADS[name]
    eph = max(16.0, e / 40.0)
    return (
        MemoryProfile(int(p * 0.5 * MB), int(eph * MB)),
        t / 3.0,
    )


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
