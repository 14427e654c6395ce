"""Iteration schedulers (paper §4): FIFO, SRTF, PACK, FAIR, PRIORITY.

A policy answers one question at every iteration boundary: *which job runs
its next iteration?* Policies are shared verbatim by the discrete-event
simulator and the live executor.

Two execution regimes (paper §5.1):
  * ``exclusive``  — at most one iteration in flight device-wide (FIFO's
    no-sharing baseline; SRTF's single-lane preemption study; PRIORITY's
    preempt-at-the-boundary serving regime),
  * concurrent     — one iteration in flight *per lane* (PACK/FAIR), i.e.
    serialization within a lane, parallelism across lanes.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Union

from repro_torch.core.types import JobSpec, JobStats

_NONE_BLOCKED: FrozenSet[int] = frozenset()


class Policy:
    name: str = "base"
    exclusive: bool = False

    def select(
        self,
        candidates: List[JobSpec],
        stats: Dict[int, JobStats],
        now: float,
        blocked: FrozenSet[int] = _NONE_BLOCKED,
    ) -> Optional[JobSpec]:
        raise NotImplementedError

    @staticmethod
    def eligible(
        candidates: List[JobSpec], blocked: FrozenSet[int]
    ) -> List[JobSpec]:
        """Drop jobs whose persistent region is paged out to host: they hold
        a lane but cannot run an iteration until the memory manager pages
        them back in at a boundary."""
        if not blocked:
            return candidates
        return [j for j in candidates if j.job_id not in blocked]

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


class FIFO(Policy):
    """Arrival order, run to completion, no sharing — the de-facto baseline
    (today's cluster behavior; subject to HOL blocking)."""

    name = "fifo"
    exclusive = True

    def select(
        self,
        candidates: List[JobSpec],
        stats: Dict[int, JobStats],
        now: float,
        blocked: FrozenSet[int] = _NONE_BLOCKED,
    ) -> Optional[JobSpec]:
        candidates = self.eligible(candidates, blocked)
        if not candidates:
            return None
        return min(candidates, key=lambda j: (j.arrival_time, j.job_id))


class SRTF(Policy):
    """Preemptive shortest-remaining-time-first. Remaining time is
    (n_iters - done) * iter_time; duration assumed known (paper assumes an
    Optimus-style estimator [41]). Preemption happens naturally at the next
    iteration boundary: the paused job's persistent memory stays resident,
    so resuming costs nothing (fast job switching, §3.2)."""

    name = "srtf"
    exclusive = True

    def select(
        self,
        candidates: List[JobSpec],
        stats: Dict[int, JobStats],
        now: float,
        blocked: FrozenSet[int] = _NONE_BLOCKED,
    ) -> Optional[JobSpec]:
        candidates = self.eligible(candidates, blocked)
        if not candidates:
            return None

        def remaining(j: JobSpec) -> float:
            done = stats[j.job_id].iterations_done if j.job_id in stats else 0
            return (j.n_iters - done) * j.iter_time

        return min(candidates, key=lambda j: (remaining(j), j.arrival_time, j.job_id))


class PACK(Policy):
    """Run every admitted lane concurrently to maximize utilization /
    minimize makespan. Within a lane: arrival order (work-conserving)."""

    name = "pack"
    exclusive = False

    def select(
        self,
        candidates: List[JobSpec],
        stats: Dict[int, JobStats],
        now: float,
        blocked: FrozenSet[int] = _NONE_BLOCKED,
    ) -> Optional[JobSpec]:
        candidates = self.eligible(candidates, blocked)
        if not candidates:
            return None
        return min(candidates, key=lambda j: (j.arrival_time, j.job_id))


class FAIR(Policy):
    """Equalize the service *rate since arrival* across the jobs sharing
    each lane (one of many possible fair policies, per the paper). Rate-
    based rather than total-service-based so a newly arriving job starts
    at its fair share immediately instead of starving incumbents until it
    has retroactively "caught up" (matches the paper's Fig. 11: shares
    re-equalize at once on arrival/departure)."""

    name = "fair"
    exclusive = False

    def select(
        self,
        candidates: List[JobSpec],
        stats: Dict[int, JobStats],
        now: float,
        blocked: FrozenSet[int] = _NONE_BLOCKED,
    ) -> Optional[JobSpec]:
        candidates = self.eligible(candidates, blocked)
        if not candidates:
            return None

        def rate(j: JobSpec) -> float:
            st = stats.get(j.job_id)
            if st is None:
                return 0.0
            elapsed = max(now - j.arrival_time, 1e-9)
            return st.service_time / elapsed

        return min(candidates, key=lambda j: (rate(j), j.arrival_time, j.job_id))


class PRIORITY(Policy):
    """Strict priority with a FAIR tie-break inside each class (paper §5.3,
    Fig. 9/10): latency-critical inference services preempt best-effort
    training at the next iteration boundary — never mid-iteration, which
    the exclusive regime guarantees structurally — and within a class the
    service *rate since arrival* is equalized, so co-resident inference
    services share fairly while a lone background training job soaks up
    every idle slot (open-loop inference is only a candidate while it has
    a pending request).

    ``aging`` bounds starvation of the low class: a job that has waited
    longer than ``aging`` seconds since its last iteration (or arrival) is
    promoted to the top class for that one decision. ``None`` (default)
    is pure strict priority — required for the simulator<->executor
    differential, where decisions must not depend on wall-clock waits.
    """

    name = "priority"
    exclusive = True

    def __init__(self, aging: Optional[float] = None) -> None:
        if aging is not None and aging <= 0:
            raise ValueError(f"aging must be positive seconds, got {aging}")
        self.aging = aging

    def select(
        self,
        candidates: List[JobSpec],
        stats: Dict[int, JobStats],
        now: float,
        blocked: FrozenSet[int] = _NONE_BLOCKED,
    ) -> Optional[JobSpec]:
        candidates = self.eligible(candidates, blocked)
        if not candidates:
            return None
        top = max(j.effective_priority for j in candidates)

        def klass(j: JobSpec) -> int:
            if self.aging is not None and j.effective_priority < top:
                st = stats.get(j.job_id)
                last = st.last_run_end if st and st.last_run_end is not None else j.arrival_time
                if now - last >= self.aging:
                    return top  # aged: one boosted decision, then demoted
            return j.effective_priority

        def rate(j: JobSpec) -> float:
            st = stats.get(j.job_id)
            if st is None:
                return 0.0
            elapsed = max(now - j.arrival_time, 1e-9)
            return st.service_time / elapsed

        return min(
            candidates, key=lambda j: (-klass(j), rate(j), j.arrival_time, j.job_id)
        )


POLICIES = {p.name: p for p in (FIFO(), SRTF(), PACK(), FAIR(), PRIORITY())}


def get_policy(name: Union[str, Policy]) -> Policy:
    """Resolve a policy from a case-insensitive name or pass an already-
    constructed :class:`Policy` through unchanged — the one blessed entry
    point, mirrored by ``placement.get_strategy``."""
    if isinstance(name, Policy):
        return name
    if isinstance(name, str):
        key = name.lower()
        if key in POLICIES:
            return POLICIES[key]
        raise KeyError(f"unknown policy {name!r}; known: {sorted(POLICIES)}")
    raise TypeError(f"policy must be a name or Policy, got {type(name).__name__}")
