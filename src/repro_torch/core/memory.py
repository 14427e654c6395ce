"""Fungible-memory manager (paper §3.3): admission control over GPU lanes.

Layered over :class:`LaneRegistry`, this adds the three mechanisms that turn
the lane safety condition from a gate into a *scheduler*:

* **Deficit-based admission control** — every job denied service (pending in
  the queue, or paged out to host) accrues a byte-denial deficit of
  ``profile.total`` per decision round. The pending queue is served
  highest-deficit-first (FIFO within equal deficit), so large jobs — the
  hardest to place — cannot be starved by a stream of small arrivals, and
  paged-out jobs are paged back in highest-deficit-first.
* **Host paging of persistent regions** — when ephemeral pressure spikes
  (a new job needs lane bytes that exist only as other jobs' *persistent*
  regions), idle victims' P is paged to host. The victim keeps its lane but
  cannot run until paged back in. The *decision* logic here is shared
  verbatim by the simulator and the live executor; only the transfer
  mechanics differ via the ``pager`` hook: the simulator models the move as
  ``bytes / page_bandwidth`` seconds, the executor really moves the
  session's tensors across the host link (pinned host copies and back).
* **Second-chance pending queue** — a job that transiently overcommits is
  not failed: it parks in the pending queue and is re-tried at every
  iteration boundary (not just at job-finish, as the bare registry does),
  with page-assisted admission. Only a job that can *never* fit
  (``P + E > C``) is rejected, immediately at arrival.

Engines drive the manager at three points and otherwise never touch the
registry's mutation API directly::

    mm.job_arrive(job, now, busy)      # submission   (1b)
    mm.iteration_boundary(now, busy)   # after every iteration     (2b)
    mm.job_finish(job, now, busy)      # completion

``busy`` is the set of job_ids currently mid-iteration: their persistent
region is live, so they are never chosen as page-out victims.

Every decision is appended to ``events`` (:class:`MemoryEvent`); the
``decision_log()`` projection is what the simulator<->executor differential
tests compare.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, List, Optional

from repro_torch.core.lanes import Lane, LaneRegistry
from repro_torch.core.types import GB, JobSpec, MemoryEvent, MemoryEventKind

# ("out" | "in", job) -> transfer seconds. None -> modeled bandwidth cost.
Pager = Callable[[str, JobSpec], float]

EMPTY: FrozenSet[int] = frozenset()


@dataclass
class MemoryConfig:
    """Knobs of the fungible-memory subsystem.

    paging: allow persistent regions to spill to host under ephemeral
        pressure. Off by default: the manager then reduces to the bare
        registry behavior plus deficit-ordered retries.
    page_bandwidth: modeled host-link bandwidth (bytes/s) used for transfer
        costs when no real pager is attached (simulator).
    deficit_quantum: bytes of deficit accrued per denied round; ``None``
        means the job's own ``profile.total`` (big jobs gain priority
        faster, matching how hard they are to place).
    max_victims_per_admission: bound on page-outs a single admission may
        trigger (caps transfer churn per decision round).
    """

    paging: bool = False
    page_bandwidth: float = 12 * GB
    deficit_quantum: Optional[int] = None
    max_victims_per_admission: int = 8


class MemoryManager:
    """Admission control + paging + second chance over a :class:`LaneRegistry`.

    The manager owns the registry's callbacks; engines subscribe via
    ``on_admit(job, lane)`` and ``on_event(event)`` instead.
    """

    def __init__(
        self,
        registry: LaneRegistry,
        config: Optional[MemoryConfig] = None,
        pager: Optional[Pager] = None,
    ) -> None:
        self.registry = registry
        self.config = config or MemoryConfig()
        self._pager = pager
        self.events: List[MemoryEvent] = []
        self.deficit: Dict[int, int] = {}
        self.chances: Dict[int, int] = {}  # failed re-admission rounds
        self.rejected: set = set()
        self.specs: Dict[int, JobSpec] = {}  # live (unfinished) jobs only
        self._order: Dict[int, int] = {}  # live job_id -> arrival ordinal
        self._next_ordinal = 0  # monotone: ordinals never reused after churn
        self._was_pending: set = set()  # left job_arrive unadmitted
        self._now = 0.0
        self.on_admit: Optional[Callable[[JobSpec, Lane], None]] = None
        self.on_event: Optional[Callable[[MemoryEvent], None]] = None
        registry.on_admit = self._handle_admit
        registry.on_lane_moved = self._handle_lane_moved

    # ------------------------------------------------------------------
    # Engine entry points
    # ------------------------------------------------------------------

    def job_arrive(
        self, job: JobSpec, now: float = 0.0, busy: FrozenSet[int] = EMPTY
    ) -> Optional[Lane]:
        """(1b) Admission request. Returns the lane if admitted immediately."""
        self._now = now
        self.specs[job.job_id] = job
        self.deficit.setdefault(job.job_id, 0)
        if job.job_id not in self._order:
            self._order[job.job_id] = self._next_ordinal
            self._next_ordinal += 1
        if job.profile.total > self.registry.capacity:
            # not even an empty device could hold it: fail fast, no chances
            self.rejected.add(job.job_id)
            self._log(MemoryEventKind.REJECT, job)
            self._forget(job.job_id)
            return None
        lane = self.registry.job_arrive(job)  # fires _handle_admit on success
        if lane is None:
            self._log(MemoryEventKind.QUEUE, job)
            if self.config.paging:
                self._page_assisted_admission(job, busy)
            lane = self.registry.assignment.get(job.job_id)
            if lane is None:
                # any later admission is a second-chance re-admission
                self._was_pending.add(job.job_id)
        return lane

    def job_finish(
        self, job: JobSpec, now: float = 0.0, busy: FrozenSet[int] = EMPTY
    ) -> None:
        self._now = now
        # deficit priority applies at every decision point, including the
        # retry that job_finish triggers (stable sort: FIFO within ties)
        self.registry.queue.sort(key=lambda j: -self.deficit.get(j.job_id, 0))
        self.registry.job_finish(job)  # frees lane bytes; retries the queue
        self._forget(job.job_id)

    def _forget(self, job_id: int) -> None:
        """Drop a terminal (finished/failed/rejected) job's bookkeeping so a
        long-lived fleet churning short jobs stays bounded. Already-logged
        events carry their ordinal (stamped at log time), so the decision
        log is unaffected; ``_next_ordinal`` keeps ordinals unique forever."""
        self.deficit.pop(job_id, None)
        self.chances.pop(job_id, None)
        self.specs.pop(job_id, None)
        self._order.pop(job_id, None)
        self._was_pending.discard(job_id)

    def iteration_boundary(
        self, now: float = 0.0, busy: FrozenSet[int] = EMPTY
    ) -> List[MemoryEvent]:
        """(2b) The second-chance tick: ephemeral regions are empty, so this
        is the safe point to re-admit, page in, and page out. Returns the
        events this round produced (non-empty means the memory state moved).
        """
        self._now = now
        reg = self.registry
        if not reg.queue and not reg.paged:
            return []  # nobody denied service: the tick cannot move state
        mark = len(self.events)
        # 1. accrue deficit for every job currently denied service
        for j in reg.queue:
            self.deficit[j.job_id] = self.deficit.get(j.job_id, 0) + self._quantum(j)
        # accrual is commutative, but iterate in sorted id order anyway so
        # no scheduling choice can ever grow out of set order here (RPL004)
        for jid in sorted(reg.paged):
            spec = self.specs[jid]
            self.deficit[jid] = self.deficit.get(jid, 0) + self._quantum(spec)
        # 2. page paged-out jobs back in, highest deficit first
        if self.config.paging and reg.paged:
            for jid in sorted(
                reg.paged, key=lambda i: (-self.deficit.get(i, 0), i)
            ):
                spec = self.specs[jid]
                if reg.can_page_in(spec):
                    reg.page_in(spec)
                    cost = self._transfer("in", spec)
                    self._log(
                        MemoryEventKind.PAGE_IN,
                        spec,
                        nbytes=spec.profile.persistent,
                        cost=cost,
                    )
        # 3. retry the pending queue, highest deficit first
        if reg.queue:
            reg.queue.sort(key=lambda j: -self.deficit.get(j.job_id, 0))
            reg.process_requests()
            # 4. page-assisted admission for whatever is still pending
            if self.config.paging:
                for j in list(reg.queue):
                    if j.job_id not in reg.assignment:
                        self._page_assisted_admission(j, busy)
            # whoever is STILL pending burned one failed re-admission round
            for j in reg.queue:
                self.chances[j.job_id] = self.chances.get(j.job_id, 0) + 1
        return self.events[mark:]

    # ------------------------------------------------------------------
    # Paging decisions (shared verbatim by simulator and executor)
    # ------------------------------------------------------------------

    def _page_assisted_admission(self, job: JobSpec, busy: FrozenSet[int]) -> None:
        """Free persistent bytes by paging idle victims until ``job`` fits.
        Bails without touching anything when no victim set can help."""
        reg = self.registry
        needed = self._bytes_needed(job)
        victims = [
            self.specs[jid]
            for jid in reg.assignment
            if jid not in reg.paged
            and jid not in busy
            and jid != job.job_id
            and self.specs[jid].profile.persistent > 0
        ]
        # well-served (low deficit) jobs with large persistent regions first
        victims.sort(
            key=lambda v: (
                self.deficit.get(v.job_id, 0),
                -v.profile.persistent,
                v.job_id,
            )
        )
        victims = victims[: self.config.max_victims_per_admission]
        if needed > sum(v.profile.persistent for v in victims):
            return  # paging cannot help; leave victims resident
        for v in victims:
            if job.job_id in reg.assignment:
                break
            nbytes = reg.page_out(v)
            cost = self._transfer("out", v)
            self._log(MemoryEventKind.PAGE_OUT, v, nbytes=nbytes, cost=cost)
            reg.process_requests()

    def _bytes_needed(self, job: JobSpec) -> int:
        """Min bytes to free for any FINDLANE strategy to admit ``job``
        (mirrors Algorithm 1's three strategies)."""
        reg = self.registry
        p, e = job.profile.persistent, job.profile.ephemeral
        base = reg.persistent_used + p + reg.lane_total
        options = [base + e]  # strategy 1: new lane
        if any(l.fits(e) for l in reg.lanes.values()):
            options.append(base)  # strategy 2: join an existing lane
        for lane in reg.lanes.values():  # strategy 3: resize a lane
            new_size = max([e] + [j.profile.ephemeral for j in lane.jobs])
            options.append(base - lane.size + new_size)
        return max(0, min(options) - reg.capacity)

    # ------------------------------------------------------------------

    def _quantum(self, job: JobSpec) -> int:
        q = self.config.deficit_quantum
        return q if q is not None else job.profile.total

    def _transfer(self, direction: str, job: JobSpec) -> float:
        if self._pager is not None:
            return self._pager(direction, job)
        return job.profile.persistent / self.config.page_bandwidth

    def _handle_admit(self, job: JobSpec, lane: Lane) -> None:
        kind = (
            MemoryEventKind.SECOND_CHANCE
            if job.job_id in self._was_pending
            else MemoryEventKind.ADMIT
        )
        self._log(kind, job, lane_id=lane.lane_id)
        if self.on_admit:
            self.on_admit(job, lane)

    def _handle_lane_moved(self, lane: Lane) -> None:
        ev = MemoryEvent(
            kind=MemoryEventKind.LANE_MOVED,
            time=self._now,
            job_id=-1,
            lane_id=lane.lane_id,
        )
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)

    def _log(self, kind: MemoryEventKind, job: JobSpec, **kw) -> None:
        ev = MemoryEvent(
            kind=kind,
            time=self._now,
            job_id=job.job_id,
            job=job,
            ordinal=self._order.get(job.job_id),
            **kw,
        )
        self.events.append(ev)
        if self.on_event:
            self.on_event(ev)

    # ------------------------------------------------------------------

    def decision_log(self, with_lanes: bool = True) -> List[tuple]:
        """Canonical (kind, arrival-ordinal, job-name[, lane_id]) projection
        of the decision sequence — time- and cost-free, so a virtual-time
        simulator run and a wall-clock executor run of the same trace can be
        compared directly. The arrival ordinal (submission order within this
        manager) disambiguates jobs that share a name, so traces with
        duplicate workload names cannot alias two different decision
        sequences into equal logs. LANE_MOVED entries are layout
        bookkeeping, not decisions: excluded."""
        out = []
        for e in self.events:
            if e.kind is MemoryEventKind.LANE_MOVED:
                continue
            if with_lanes:
                out.append((e.kind.value, e.ordinal, e.name, e.lane_id))
            else:
                out.append((e.kind.value, e.ordinal, e.name))
        return out

    def stats(self) -> Dict:
        s = self.registry.stats()
        kinds = [e.kind for e in self.events]
        s.update(
            page_outs=kinds.count(MemoryEventKind.PAGE_OUT),
            page_ins=kinds.count(MemoryEventKind.PAGE_IN),
            second_chance_admits=kinds.count(MemoryEventKind.SECOND_CHANCE),
            rejected=len(self.rejected),
            transfer_seconds=sum(e.cost for e in self.events),
            deficit_outstanding=sum(self.deficit.values()),
        )
        return s
