"""Session: the executor-side handle of one DL job (paper §3.1).

A session owns the job's *persistent* state (a pytree of device tensors —
params, optimizer state — that stays resident across switches) and yields
iterations to the executor. The adaptor creates sessions from user-level
step functions without the user script changing.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core.types import JobSpec, MemoryProfile


def synchronize(device: torch.device) -> None:
    """Wait for all work queued on ``device`` (a no-op for the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Session:
    """Wraps (step_fn, state, data source) into an iteration supplier."""

    def __init__(
        self,
        name: str,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        init_state: Any,
        data_fn: Callable[[int], Any],  # step index -> batch
        n_iters: int,
        profile: MemoryProfile,
        iter_time: float = 0.01,
        utilization: float = 1.0,
        arrival_time: float = 0.0,
        kind: str = "train",
        priority: Optional[int] = None,
        request_times: Optional[tuple] = None,  # open-loop request stream
        *,
        device: torch.device,
    ) -> None:
        self.name = name
        self.step_fn = step_fn
        self.state = init_state
        self.data_fn = data_fn
        self.n_iters = n_iters
        self.device = torch.device(device)
        self.iterations_run = 0
        self.metrics_log = []
        self.job = JobSpec(
            name=name,
            profile=profile,
            n_iters=n_iters,
            iter_time=iter_time,
            utilization=utilization,
            arrival_time=arrival_time,
            kind=kind,
            priority=priority,
            request_times=request_times,
            run_iteration=self.run_iteration,
        )

    def run_iteration(self, index: int) -> float:
        """Execute one iteration on-device; returns wall seconds. Blocks
        until the device has finished all queued work, the iteration's
        included (the executor serializes within a lane, matching
        iteration-granularity scheduling)."""
        t0 = time.perf_counter()
        batch = self.data_fn(index)
        out = self.step_fn(self.state, batch)
        if isinstance(out, tuple):
            self.state, metrics = out
        else:
            self.state, metrics = out, None
        synchronize(self.device)
        self.iterations_run += 1
        if metrics is not None:
            self.metrics_log.append(metrics)
        return time.perf_counter() - t0

    @property
    def finished(self) -> bool:
        return self.iterations_run >= self.n_iters
