"""Fault tolerance: straggler detection, failure injection, restart
supervision. Host-side only — nothing here touches device state, so
it composes with any mesh/backend.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple, Type


class InjectedFailure(RuntimeError):
    """Deliberate failure raised by :class:`FailureInjector` (and the only
    exception class :class:`RestartSupervisor` treats as restartable by
    default)."""


@dataclass(frozen=True)
class StragglerReport:
    step: int
    duration: float
    sigma: float  # how many stds above the running mean
    mean: float
    std: float


class StragglerMonitor:
    """Online step-time outlier detector (Welford mean/variance).

    ``observe(step, dur)`` returns a :class:`StragglerReport` when ``dur``
    exceeds the running mean by more than ``k`` stds, else None. Flagged
    steps are excluded from the statistics (one straggler must not inflate
    the variance and mask the next), and collected in ``.flagged``.

    The std is floored at 1% of the mean: early in a run the sample
    variance of near-identical step times is ~0, and without the floor
    every timer jitter would flag.
    """

    def __init__(self, k: float = 3.0, warmup: int = 10):
        self.k = k
        self.warmup = max(int(warmup), 2)
        self.flagged: List[StragglerReport] = []
        self._n = 0
        self._mean = 0.0
        self._m2 = 0.0

    def observe(self, step: int, dur: float) -> Optional[StragglerReport]:
        if self._n >= self.warmup:
            std = math.sqrt(self._m2 / (self._n - 1))
            std = max(std, 0.01 * abs(self._mean), 1e-12)
            sigma = (dur - self._mean) / std
            if sigma > self.k:
                rep = StragglerReport(step, dur, sigma, self._mean, std)
                self.flagged.append(rep)
                return rep
        self._n += 1
        delta = dur - self._mean
        self._mean += delta / self._n
        self._m2 += delta * (dur - self._mean)
        return None


class FailureInjector:
    """Raise :class:`InjectedFailure` the first time each listed step is
    reached; subsequent passes over the same step (post-restart) proceed."""

    def __init__(self, steps: Optional[Sequence[int]] = None):
        self.steps = {int(s) for s in (steps or [])}
        self.fired: set = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.steps and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected failure at step {step}")


class RestartSupervisor:
    """Run a step-loop body under a bounded restart budget.

    ``run(body, resume_step)`` calls ``resume_step()`` to recover the start
    step (e.g. from the latest checkpoint), then ``body(start)``. A
    restartable failure increments ``.restarts`` and re-enters the loop;
    exceeding ``max_restarts`` raises RuntimeError.
    """

    def __init__(
        self,
        max_restarts: int = 3,
        restartable: Tuple[Type[BaseException], ...] = (InjectedFailure,),
    ):
        self.max_restarts = max_restarts
        self.restartable = restartable
        self.restarts = 0

    def run(self, body: Callable[[int], int], resume_step: Callable[[], int]) -> int:
        while True:
            start = resume_step()
            try:
                return body(start)
            except self.restartable as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise RuntimeError(
                        f"restart budget exhausted ({self.max_restarts} allowed): {e}"
                    ) from e
