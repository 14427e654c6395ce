"""Shared event-core: one kernel owns time, ordinals, and event ordering
(the port's copy of the JAX package's ``core/events.py``).

Every engine that deals in *when* — the discrete-event :class:`Simulator`
and the fleet's epoch loops — consumes this module instead of rolling its
own heap / counter / ``t += interval`` arithmetic. That is the
contract that keeps the differential suite honest: if two engines disagree
about event order, the bug is *here*, in one place.

Two primitives:

:class:`EventQueue`
    A generation-tagged bucket queue over ``(time, seq, kind, job, gen)``
    tuples. The heap is keyed on ``(time, seq)``; ``seq`` is a process-local
    ordinal stamped at push time, so insertion order breaks time ties
    deterministically. ``pop_batch`` drains the whole head *bucket* — every
    event within the tie tolerance of the head timestamp — and returns it
    sorted by ordinal, so a batch of simultaneous arrivals is presented to
    the scheduler as one unit even when accumulated float error has smeared
    their timestamps by an ulp or two (exact ``==`` grouping split such
    batches between engines).
    Generations invalidate in-flight events wholesale: ``invalidate(job_id)``
    bumps the job's generation, and events stamped with an older generation
    are reported stale by ``is_stale`` — the migration/re-placement
    machinery never has to dig entries out of the heap.

    Bulk loads (a whole trace's arrival events at ``start()``) go through
    ``defer()``: pushes append raw and the heap property is restored with a
    single O(n) ``heapify`` at the first pop/peek, which is what makes
    million-job seeding cheap.

:class:`EpochSchedule`
    The rebalance/commit cadence. Boundaries are produced by repeated
    addition (``t += interval``), NOT ``k * interval``, because that is the
    accumulation the epoch loops have always used and decision-log parity
    is bitwise: switching to multiplication would move late boundaries by
    an ulp and re-bucket events between epochs.

The queue clock (`now`) is monotone: pops and ``clamp`` only ever move it
forward. Batch pops timestamp the whole bucket at the *head* event's time —
collapsing the smeared timestamps back onto one instant — so every engine
sees the batch happen "at" the same moment.
"""
from __future__ import annotations

from heapq import heapify, heappop, heappush
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.types import JobSpec

# One event: (time, seq, kind, job, gen). A plain tuple, not a dataclass —
# the simulator kernel pops millions of these per sweep and tuple creation
# plus C-level (time, seq) comparison is what keeps the loop in "seconds"
# territory for the 10^6-job diurnal benchmark (bench_simloop).
Event = Tuple[float, int, str, JobSpec, int]

EV_TIME = 0
EV_SEQ = 1
EV_KIND = 2
EV_JOB = 3
EV_GEN = 4

# Relative tie tolerance for bucket draining. Two events are "simultaneous"
# when their timestamps differ by at most TIE_EPS * max(1, |t|): wide enough
# to absorb accumulated float error from long event chains (the failure mode
# the exact-equality drain had), narrow enough that genuinely distinct
# instants — trace generators emit millisecond-scale gaps at their finest —
# never collapse.
TIE_EPS = 1e-9


class EventQueue:
    """Generation-tagged bucket queue; owns time, ordinals, event order."""

    __slots__ = ("now", "tie_eps", "_heap", "_next_seq", "_gen", "_deferred")

    def __init__(self, tie_eps: float = TIE_EPS) -> None:
        self.now = 0.0
        self.tie_eps = tie_eps
        self._heap: List[Event] = []
        self._next_seq = 0
        self._gen: Dict[int, int] = {}
        self._deferred = False

    # -- introspection ------------------------------------------------

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def peek_time(self) -> Optional[float]:
        """Timestamp of the earliest event, or None when empty."""
        if not self._heap:
            return None
        self._ensure_heap()
        return self._heap[0][EV_TIME]

    # -- generations ---------------------------------------------------

    def generation(self, job_id: int) -> int:
        return self._gen.get(job_id, 0)

    def invalidate(self, job_id: int) -> int:
        """Bump ``job_id``'s generation so its queued events go stale.
        Returns the new generation (subsequent pushes stamp it)."""
        g = self._gen.get(job_id, 0) + 1
        self._gen[job_id] = g
        return g

    def is_stale(self, ev: Event) -> bool:
        """True when ``ev`` was invalidated after it was pushed (the job
        migrated away, was re-placed, or was cancelled)."""
        return ev[EV_GEN] != self._gen.get(ev[EV_JOB].job_id, 0)

    # -- insertion -----------------------------------------------------

    def push(self, time: float, kind: str, job: JobSpec) -> None:
        """Queue an event; stamps the next ordinal and the job's current
        generation. Ordinals are never reused, so (time, seq) is a total
        order and same-instant events replay in push order."""
        ev: Event = (time, self._next_seq, kind, job, self._gen.get(job.job_id, 0))
        self._next_seq += 1
        if self._deferred:
            self._heap.append(ev)
        else:
            heappush(self._heap, ev)

    def defer(self) -> None:
        """Enter bulk-load mode: subsequent pushes append raw; the heap
        property is restored lazily with one O(n) heapify at the next
        pop/peek. Call before seeding a whole trace."""
        self._deferred = True

    def _ensure_heap(self) -> None:
        if self._deferred:
            heapify(self._heap)
            self._deferred = False

    # -- removal -------------------------------------------------------

    def pop(self) -> Event:
        """Pop the earliest event and advance the clock to it."""
        self._ensure_heap()
        ev = heappop(self._heap)
        t = ev[EV_TIME]
        if t > self.now:
            self.now = t
        return ev

    def pop_batch(self, until: Optional[float] = None) -> Optional[List[Event]]:
        """Drain the head bucket: every event within the tie tolerance of
        the earliest timestamp, returned sorted by ordinal (push order).
        Advances the clock to the *head* time — the whole bucket happens
        "at" one instant. Returns None when the queue is empty or the head
        lies beyond ``until`` (the clock is then left for ``clamp``)."""
        heap = self._heap
        if not heap:
            return None
        self._ensure_heap()
        t0 = heap[0][EV_TIME]
        if until is not None and t0 > until:
            return None
        # absolute tolerance for this bucket; max(1, |t0|) keeps it relative
        # for large clocks without vanishing near t=0
        tol = self.tie_eps * (abs(t0) if abs(t0) > 1.0 else 1.0)
        horizon = t0 + tol
        batch = [heappop(heap)]
        while heap and heap[0][EV_TIME] <= horizon:
            batch.append(heappop(heap))
        if len(batch) > 1:
            # ordinal-stable: within the bucket, replay in push order even
            # when float error reordered the smeared timestamps
            batch.sort(key=lambda ev: ev[EV_SEQ])
        if t0 > self.now:
            self.now = t0
        return batch

    def clamp(self, until: Optional[float]) -> None:
        """Advance the clock to the horizon (end of an ``advance(until)``
        sweep that ran out of events before the horizon)."""
        if until is not None and until > self.now:
            self.now = until


class EpochSchedule:
    """Rebalance/commit cadence of the fleet's epoch loops.

    Boundaries accumulate by repeated addition from 0.0 — the arithmetic
    the epoch loops have always used — so adopting the shared schedule
    cannot move a boundary by even an ulp relative to the old inline
    ``t += interval`` loops (decision-log parity is bitwise)."""

    __slots__ = ("interval",)

    def __init__(self, interval: float) -> None:
        if not interval > 0.0:
            raise ValueError(f"epoch interval must be positive, got {interval!r}")
        self.interval = float(interval)

    def next_boundary(self, t: float) -> float:
        """The boundary after ``t`` (the epoch loop's ``t += interval``)."""
        return t + self.interval

    def boundaries(self, start: float = 0.0) -> Iterator[float]:
        """Infinite boundary stream: start+dt, start+2dt, ... (by repeated
        addition; callers break out when their engines go quiescent)."""
        t = start
        while True:
            t = t + self.interval
            yield t


def as_schedule(
    interval: "float | EpochSchedule | None",
) -> Optional[EpochSchedule]:
    """Coerce a raw interval (the engines' historical keyword type) to an
    :class:`EpochSchedule`; None passes through (no epoch loop)."""
    if interval is None or isinstance(interval, EpochSchedule):
        return interval
    return EpochSchedule(interval)
