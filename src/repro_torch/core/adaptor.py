"""Framework adaptor (paper Fig. 3): users keep their step functions; the
adaptor presents Salus as a virtual device.

    vdev = VirtualDevice(executor)
    sess = vdev.create_session(step_fn, state, data_fn, n_iters)   # (1a,1b)
    vdev.run()                                                     # (2a,2b)

PyTorch runs eagerly, so there is nothing to compile: a memory profile
that is not supplied is measured by running one step on the executor's
device (``profiles.profile_step``) and discarding its output. That is
right for a step that returns new state; a step that updates its state in
place (the AdamW train step) would take a hidden step there, so its
caller passes a profile from ``profiles.profile_model``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional

from repro_torch.core.executor import ExecutorReport, SalusExecutor
from repro_torch.core.profiles import profile_step
from repro_torch.core.session import Session
from repro_torch.core.types import MemoryProfile


class VirtualDevice:
    def __init__(self, executor: SalusExecutor) -> None:
        self.executor = executor
        self._sessions: List[Session] = []

    def create_session(
        self,
        name: str,
        step_fn: Callable,
        init_state: Any,
        data_fn: Callable[[int], Any],
        n_iters: int,
        profile: Optional[MemoryProfile] = None,
        utilization: float = 1.0,
        kind: str = "train",
        iter_time: float = 0.01,
        arrival_time: float = 0.0,
        priority: Optional[int] = None,
        request_times: Optional[tuple] = None,
    ) -> Session:
        """Register one job. ``iter_time``/``arrival_time`` are forwarded to
        the :class:`Session` verbatim — FAIR's service-rate computation and
        ``accounting="nominal"`` both read them off the JobSpec.
        ``request_times`` makes the session an open-loop inference service:
        iteration k serves the request arriving at ``request_times[k]``."""
        device = self.executor.device
        if profile is None:
            profile = profile_step(step_fn, init_state, data_fn(0), device)
        sess = Session(
            name=name,
            step_fn=step_fn,
            init_state=init_state,
            data_fn=data_fn,
            n_iters=n_iters,
            profile=profile,
            kind=kind,
            utilization=utilization,
            iter_time=iter_time,
            arrival_time=arrival_time,
            priority=priority,
            request_times=request_times,
            device=device,
        )
        self._sessions.append(sess)
        self.executor.submit(sess)
        return sess

    def run(self, max_wall: Optional[float] = None) -> ExecutorReport:
        return self.executor.run(max_wall=max_wall)
