"""GPU-lane abstraction + Algorithm 1 (lane assignment) + auto-defrag.

Memory layout (paper Fig. 7): the persistent region grows upward from
address 0; the ephemeral region is carved into *lanes* growing downward
from the capacity C. Iteration execution serializes within a lane and
parallelizes across lanes. The registry maintains the safety condition

    sum_i P_i + sum_j L_j <= C,      L_j = max_{i in lane j} E_i

at every event (job arrival / finish / lane move). Auto-defragmentation
(§3.3.1) compacts lanes at iteration boundaries: since ephemeral memory is
empty between iterations, moving a lane costs zero bytes of copying — the
registry just rewrites base addresses and fires LANEMOVED.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.types import JobSpec, MemoryProfile


@dataclass
class Lane:
    lane_id: int
    size: int  # L_j bytes (== max ephemeral of resident jobs)
    base: int  # current base address (top-down layout)
    jobs: List[JobSpec] = field(default_factory=list)

    @property
    def ref(self) -> int:
        return len(self.jobs)

    def fits(self, ephemeral: int) -> bool:
        return self.size >= ephemeral

    def __repr__(self) -> str:
        return f"Lane#{self.lane_id}(size={self.size}, base={self.base}, ref={self.ref})"


class SafetyViolation(RuntimeError):
    pass


class LaneRegistry:
    """Algorithm 1, event-driven. Callbacks let the executor/simulator react
    to admissions and lane moves."""

    def __init__(self, capacity: int) -> None:
        self.capacity = int(capacity)
        self.lanes: Dict[int, Lane] = {}
        self._lane_total = 0  # invariant: == sum(l.size for l in lanes)
        self.persistent_used = 0
        self.queue: List[JobSpec] = []  # Q, FIFO order
        self.assignment: Dict[int, Lane] = {}  # job_id -> lane
        self._ids = itertools.count()
        self.on_admit: Optional[Callable[[JobSpec, Lane], None]] = None
        self.on_lane_moved: Optional[Callable[[Lane], None]] = None
        self.moves = 0  # defrag lane-move count (all zero-copy)
        self.paged: set = set()  # job_ids whose persistent region lives on host

    # ------------------------------------------------------------------
    # Invariants
    # ------------------------------------------------------------------

    @property
    def lane_total(self) -> int:
        # maintained incrementally (sum L_j is on the per-event hot path of
        # a million-job sweep); check_invariants re-derives it from scratch
        return self._lane_total

    def safety_ok(self, extra_p: int = 0, extra_lane: int = 0) -> bool:
        return (
            self.persistent_used + extra_p + self._lane_total + extra_lane
            <= self.capacity
        )

    def check_invariants(self) -> None:
        actual_total = sum(l.size for l in self.lanes.values())
        if actual_total != self._lane_total:
            raise SafetyViolation(
                f"lane_total cache {self._lane_total} != actual {actual_total}"
            )
        if not self.safety_ok():
            raise SafetyViolation(
                f"P={self.persistent_used} + L={self.lane_total} > C={self.capacity}"
            )
        lanes = self.lanes
        if len(lanes) == 1:
            # fast path: one lane must sit anchored at the capacity top,
            # above the persistent region — no sorting machinery needed
            (lane,) = lanes.values()
            if lane.base + lane.size != self.capacity:
                raise SafetyViolation("lanes not anchored at capacity top")
            if lane.base < self.persistent_used:
                raise SafetyViolation("ephemeral region collided with persistent")
        elif lanes:
            # lanes must tile [top - sum(sizes), top) contiguously, no overlap
            occupied = sorted(
                ((l.base, l.base + l.size) for l in lanes.values()),
            )
            for (a0, a1), (b0, b1) in zip(occupied, occupied[1:]):
                if a1 > b0:
                    raise SafetyViolation(f"lane overlap: {occupied}")
            if occupied[0][0] < self.persistent_used:
                raise SafetyViolation("ephemeral region collided with persistent")
            if occupied[-1][1] != self.capacity:
                raise SafetyViolation("lanes not anchored at capacity top")
            for (a0, a1), (b0, b1) in zip(occupied, occupied[1:]):
                if a1 != b0:
                    raise SafetyViolation("lanes not contiguous (defrag missed)")
        for lane in lanes.values():
            for job in lane.jobs:
                if job.profile.ephemeral > lane.size:
                    raise SafetyViolation(
                        f"job E={job.profile.ephemeral} > lane size {lane.size}"
                    )

    # ------------------------------------------------------------------
    # Algorithm 1
    # ------------------------------------------------------------------

    def job_arrive(self, job: JobSpec) -> Optional[Lane]:
        """JOBARRIVE: enqueue and process. Returns the lane if admitted now."""
        self.queue.append(job)
        self.process_requests()
        return self.assignment.get(job.job_id)

    def job_finish(self, job: JobSpec) -> None:
        """JOBFINISH: drop refcount; delete the lane at zero; defrag; retry Q.
        When the departing job was the lane's largest, the lane shrinks to the
        remaining residents' max E (shrink is part of auto-defrag: between
        iterations the ephemeral region is empty, so it is zero-copy)."""
        self.job_depart(job)

    def job_depart(self, job: JobSpec) -> int:
        """Remove ``job`` from this device without finishing it — the source
        half of a migration (JOBFINISH is a departure whose job happens to be
        done; both release the same resources). Returns the persistent bytes
        that were resident on-device (0 for a paged-out or still-queued job),
        i.e. what a migration must move across the host link."""
        lane = self.assignment.pop(job.job_id, None)
        if lane is None:
            if job in self.queue:  # departed (killed/migrated) while queued
                self.queue.remove(job)
            return 0
        lane.jobs.remove(job)
        if job.job_id in self.paged:
            self.paged.discard(job.job_id)  # persistent already off-device
            freed = 0
        else:
            self.persistent_used -= job.profile.persistent
            freed = job.profile.persistent
        if lane.ref == 0:
            del self.lanes[lane.lane_id]
            self._lane_total -= lane.size
            self._defragment()
        else:
            new_size = max(j.profile.ephemeral for j in lane.jobs)
            if new_size < lane.size:
                self._resize_lane(lane, new_size)
        self.process_requests()
        return freed

    def process_requests(self) -> None:
        """PROCESSREQUESTS: admit queued jobs in FIFO order where possible."""
        if not self.queue:
            self.check_invariants()
            return
        admitted = []
        for job in list(self.queue):
            lane = self._find_lane(job.profile)
            if lane is None:
                continue
            self.queue.remove(job)
            lane.jobs.append(job)
            self.persistent_used += job.profile.persistent
            self.assignment[job.job_id] = lane
            admitted.append((job, lane))
        self.check_invariants()
        for job, lane in admitted:
            if self.on_admit:
                self.on_admit(job, lane)

    def _find_lane(self, prof: MemoryProfile) -> Optional[Lane]:
        """FINDLANE(P, E) — three strategies, in paper order."""
        p, e = prof.persistent, prof.ephemeral
        if e <= 0 or p < 0:
            raise ValueError(f"bad profile {prof}")
        # 1. try to create a new lane
        if self.persistent_used + p + self.lane_total + e <= self.capacity:
            return self._new_lane(e)
        # 2. try to put into an existing lane (best fit: smallest L_j >= E)
        candidates = [l for l in self.lanes.values() if l.fits(e)]
        if candidates and self.persistent_used + p + self.lane_total <= self.capacity:
            return min(candidates, key=lambda l: (l.size, l.lane_id))
        # 3. try to replace (resize) an existing lane, smallest L_r first.
        # L_j is *defined* as the max ephemeral of the lane's jobs, so the
        # new size is max(E, resident jobs' E) — never squeezing residents.
        for lane in sorted(self.lanes.values(), key=lambda l: (l.size, l.lane_id)):
            new_size = max([e] + [j.profile.ephemeral for j in lane.jobs])
            if (
                self.persistent_used + p + self.lane_total - lane.size + new_size
                <= self.capacity
            ):
                self._resize_lane(lane, new_size)
                return lane
        return None

    # ------------------------------------------------------------------
    # Fungible persistent memory: host paging hooks (used by MemoryManager)
    # ------------------------------------------------------------------

    def page_out(self, job: JobSpec) -> int:
        """Move ``job``'s persistent region off-device. The job keeps its lane
        (its L_j reservation survives — E is fungible only across iterations,
        P only across the host link) but cannot run until paged back in.
        Returns the number of bytes freed on-device."""
        if job.job_id not in self.assignment:
            raise ValueError(f"page_out of unassigned job {job.name}")
        if job.job_id in self.paged:
            raise ValueError(f"{job.name} already paged out")
        self.paged.add(job.job_id)
        self.persistent_used -= job.profile.persistent
        return job.profile.persistent

    def can_page_in(self, job: JobSpec) -> bool:
        return job.job_id in self.paged and self.safety_ok(
            extra_p=job.profile.persistent
        )

    def page_in(self, job: JobSpec) -> int:
        """Bring a paged-out persistent region back on-device."""
        if job.job_id not in self.paged:
            raise ValueError(f"page_in of non-paged job {job.name}")
        if not self.safety_ok(extra_p=job.profile.persistent):
            raise SafetyViolation(f"page_in of {job.name} would violate safety")
        self.paged.discard(job.job_id)
        self.persistent_used += job.profile.persistent
        self.check_invariants()
        return job.profile.persistent

    # ------------------------------------------------------------------
    # Layout management (top-down contiguous lanes) + auto-defrag
    # ------------------------------------------------------------------

    def _new_lane(self, size: int) -> Lane:
        base = self.capacity - self._lane_total - size
        lane = Lane(next(self._ids), size, base)
        self.lanes[lane.lane_id] = lane
        self._lane_total += size
        return lane

    def _resize_lane(self, lane: Lane, new_size: int) -> None:
        if any(j.profile.ephemeral > new_size for j in lane.jobs):
            raise SafetyViolation("shrinking lane below resident job's E")
        self._lane_total += new_size - lane.size
        lane.size = new_size
        self._defragment()

    def _defragment(self) -> None:
        """Re-pack lanes contiguously from the top. Zero-copy by design:
        called only at iteration boundaries when ephemeral regions are empty
        (§3.3.1). Fires LANEMOVED for every relocated lane."""
        cursor = self.capacity
        moved = []
        for lane in sorted(self.lanes.values(), key=lambda l: -l.base):
            cursor -= lane.size
            if lane.base != cursor:
                lane.base = cursor
                moved.append(lane)
        self.moves += len(moved)
        for lane in moved:
            if self.on_lane_moved:
                self.on_lane_moved(lane)

    # ------------------------------------------------------------------

    def stats(self) -> Dict:
        return {
            "capacity": self.capacity,
            "persistent_used": self.persistent_used,
            "lane_total": self.lane_total,
            "n_lanes": len(self.lanes),
            "queued": len(self.queue),
            "free": self.capacity - self.persistent_used - self.lane_total,
            "moves": self.moves,
            "paged": len(self.paged),
        }
