"""Discrete-event simulator for Salus traces (paper §5.1 scale); the port's
copy of the JAX package's ``core/simulator.py``, on the port's own lanes,
memory, scheduler, engine and event modules.

Faithful to the paper's mechanism:
  * admission through the lane registry (Algorithm 1 + safety condition),
  * iteration-granularity scheduling & preemption (a running iteration is
    never aborted; switches happen at boundaries),
  * serialization within a lane / concurrency across lanes,
  * compute-contention model: an iteration started while
    lanes A are active takes ``iter_time * max(1, sum_{j in A} u_j)``
    wall-clock — compute is one shared resource, so packing compute-bound
    jobs doesn't help (paper Fig. 12 resnet) while packing low-utilization
    jobs does (superres), and k-way FAIR sharing gives each job 1/k of its
    solo throughput with constant aggregate (Fig. 11).
  * optional per-switch latency (``switch_overhead``) to model Salus's small
    switching cost vs. checkpoint-based switching (Gandiva): used by the
    overhead/switching benchmarks.

The simulator satisfies the :class:`~repro_torch.core.engine.Engine` protocol:
``run()`` is ``start() + advance(until) + result()``. The JAX package's
fleet surface on top of that (``drain_running``, ``migrate_out`` /
``migrate_in``, ``remove_pending``, ``cancel`` and resuming a job at an
iteration boundary) is not ported yet: it comes with the port's cluster
driver, its only caller.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core.engine import DecisionLog, ResultSurface
from repro_torch.core.events import Event, EventQueue
from repro_torch.core.lanes import Lane, LaneRegistry
from repro_torch.core.memory import MemoryConfig, MemoryManager
from repro_torch.core.scheduler import Policy, get_policy
from repro_torch.core.types import (
    IterationRecord,
    JobSpec,
    JobState,
    JobStats,
    MemoryEvent,
    MemoryEventKind,
)

# states that make a lane-resident job a scheduling candidate (hoisted off
# the per-event hot path)
_RUNNABLE = (JobState.READY, JobState.PAUSED)


@dataclass
class SimResult(ResultSurface):
    stats: Dict[int, JobStats]
    jobs: Dict[int, JobSpec]
    records: List[IterationRecord]
    makespan: float
    registry_stats: Dict
    memory_events: List[MemoryEvent] = field(default_factory=list)
    decision_log: DecisionLog = field(default_factory=DecisionLog)

    # jcts / avg_jct / p95_jct / utilization / completed / per_job /
    # request_latencies come from ResultSurface.

    def _collect(self, fn: Callable[[JobStats], Optional[float]]) -> List[float]:
        vals = [fn(s) for s in self.stats.values()]
        return [v for v in vals if v is not None]

    @property
    def avg_queuing(self) -> float:
        v = self._collect(lambda s: s.queuing)
        return sum(v) / len(v) if v else 0.0

    def summary(self) -> Dict:
        return {
            "makespan": self.makespan,
            "avg_jct": self.avg_jct,
            "p95_jct": self.p95_jct,
            "avg_queuing": self.avg_queuing,
            "n_jobs": len(self.stats),
            "completed": self.completed,
            "lane_moves": self.registry_stats.get("moves", 0),
            "page_outs": self.registry_stats.get("page_outs", 0),
            "page_ins": self.registry_stats.get("page_ins", 0),
            "second_chance_admits": self.registry_stats.get("second_chance_admits", 0),
            "rejected": self.registry_stats.get("rejected", 0),
            "transfer_seconds": self.registry_stats.get("transfer_seconds", 0.0),
        }


class Simulator:
    def __init__(
        self,
        capacity: int,
        policy: Policy,
        switch_overhead: float = 0.0,
        memory: Optional[MemoryConfig] = None,
    ) -> None:
        self.registry = LaneRegistry(capacity)
        self.memory = MemoryManager(self.registry, memory)
        self.policy = get_policy(policy)
        self.switch_overhead = switch_overhead
        self._submitted: List[JobSpec] = []
        self._started = False
        # live run state (populated by start())
        self._stats: Dict[int, JobStats] = {}
        self._state: Dict[int, JobState] = {}
        self._jobs: Dict[int, JobSpec] = {}
        self._records: List[IterationRecord] = []
        self._running_iter: Dict[int, Tuple[JobSpec, float]] = {}  # lane -> (job, t0)
        self._last_on_device: Dict[int, int] = {}  # lane_id -> job_id (switches)
        self._transfer_delay: Dict[int, float] = {}  # job_id -> pending paging s
        self._pending_out_cost = 0.0  # page-out time owed by the next admission
        self._last_ran: Optional[int] = None  # job whose iteration just ended
        # the event-core owns time, ordinals, and generation stamps: all
        # event pushes/pops and clock movement go through this one kernel
        # (shared with every other engine — see events.py)
        self._q = EventQueue()
        self._horizon: Optional[float] = None  # current advance() bound

    # ------------------------------------------------------------------
    # Engine protocol
    # ------------------------------------------------------------------

    def submit(self, job: JobSpec) -> None:
        """Queue a job for the next ``run()`` / ``start()`` call. Raises on
        a duplicate ``job_id``: JobSpec equality/hashing key on the id, so
        two distinct specs sharing one would silently alias in every
        per-job dict downstream (registry, stats, decision logs)."""
        if any(j.job_id == job.job_id for j in self._submitted):
            raise ValueError(
                f"duplicate job_id {job.job_id} ({job.name!r}): already submitted"
            )
        self._submitted.append(job)

    def run(self, jobs: Optional[List[JobSpec]] = None, until: Optional[float] = None) -> SimResult:
        """One-shot drive: start the trace, advance to the horizon (or
        exhaustion), return the result. Equivalent to the resumable
        ``start(); advance(until); result()`` sequence."""
        self.start(self._submitted if jobs is None else jobs)
        self.advance(until)
        return self.result()

    def decision_log(self) -> List[tuple]:
        return self.memory.decision_log()

    # ------------------------------------------------------------------
    # Driving surface: run() = start() + advance() + result()
    # ------------------------------------------------------------------

    def start(self, jobs: List[JobSpec]) -> None:
        """Install the trace: per-job bookkeeping + arrival/request events.
        Call once; drive with ``advance`` afterwards."""
        if self._started:
            raise RuntimeError("Simulator.start() called twice; use a fresh instance")
        self._started = True
        self.memory.on_admit = self._on_admit
        self.memory.on_event = self._on_mem_event
        # bulk load: arrival/request pushes append raw, one O(n) heapify at
        # the first pop — the difference between seeding a million-job trace
        # in tenths of a second vs. several
        self._q.defer()
        for job in jobs:
            self.add_pending(job)

    def advance(self, until: Optional[float] = None) -> None:
        """Process events up to ``until`` (inclusive; None = exhaustion).
        Iterations may *start* at any time <= until; ones still in flight at
        the horizon stay in flight. The clock is
        clamped to the horizon so makespan bookkeeping never reflects a
        timestamp past it."""
        if not self._started:
            raise RuntimeError("advance() before start()")
        self._horizon = until  # bounds the solo fast-forward (see _start_iteration)
        q = self._q
        while q:
            # drain the whole head bucket before scheduling: a batch of
            # simultaneous arrivals must all be visible to the policy before
            # an iteration starts (the executor likewise submits a whole
            # batch before its first scheduling decision). The event-core's
            # ordinal-stable tie grouping — not exact float equality — picks
            # the bucket, so accumulated float error cannot split a batch
            # between engines.
            batch = q.pop_batch(until)
            if batch is None:
                break  # head lies beyond the horizon; events stay queued
            live = False
            for ev in batch:
                live = self._handle(ev) or live
            self._schedule()
            self._idle_ticks(live)
        q.clamp(until)

    def result(self) -> SimResult:
        """Snapshot the run into a :class:`SimResult` (idempotent)."""
        mm = self.memory
        # jobs still pending at the end never saw a SECOND_CHANCE admit;
        # surface their failed re-admission rounds in the per-job record
        for jid, st in self._stats.items():
            st.second_chances = max(st.second_chances, mm.chances.get(jid, 0))
        makespan = (
            max(
                (s.finish_time if s.finish_time is not None else self._q.now)
                for s in self._stats.values()
            )
            if self._stats
            else 0.0
        )
        return SimResult(
            self._stats,
            dict(self._jobs),
            self._records,
            makespan,
            mm.stats(),
            memory_events=mm.events,
            decision_log=DecisionLog(mm.decision_log()),
        )

    def add_pending(self, job: JobSpec) -> None:
        """Bind a not-yet-arrived job to this device: bookkeeping + arrival
        (and request) events."""
        if job.job_id in self._jobs:
            raise ValueError(
                f"duplicate job_id {job.job_id} ({job.name!r}): already bound here"
            )
        self._jobs[job.job_id] = job
        self._stats[job.job_id] = JobStats(arrival_time=job.arrival_time)
        self._state[job.job_id] = JobState.QUEUED
        self._q.push(job.arrival_time, "arrival", job)
        if job.request_times:
            # open-loop services: each request arrival is an event that
            # wakes the scheduler (requests queue; they are not
            # always-ready iterations)
            for rt in job.request_times:
                self._q.push(max(rt, job.arrival_time), "request", job)

    # ------------------------------------------------------------------
    # Internals (the run() loop, as instance state)
    # ------------------------------------------------------------------

    def _active_utilization(self) -> float:
        return sum(j.utilization for j, _ in self._running_iter.values())

    def _busy(self) -> frozenset:
        return frozenset(j.job_id for j, _ in self._running_iter.values())

    def _candidates_in(self, lane: Lane) -> List[JobSpec]:
        now = self._q.now
        state, stats = self._state, self._stats
        return [
            j
            for j in lane.jobs
            if state[j.job_id] in _RUNNABLE
            and j.request_pending(stats[j.job_id].iterations_done, now)
        ]

    def _start_iteration(self, lane: Lane, job: JobSpec) -> None:
        now = self._q.now
        st = self._stats[job.job_id]
        if st.first_run_time is None:
            st.first_run_time = now
        self._state[job.job_id] = JobState.RUNNING
        overhead = 0.0
        # switch detection: device-wide for exclusive policies, per-lane
        # (per GPU stream) for concurrent ones
        switch_key = 0 if self.policy.exclusive else lane.lane_id
        if self.switch_overhead and self._last_on_device.get(switch_key) != job.job_id:
            overhead = self.switch_overhead
        self._last_on_device[switch_key] = job.job_id
        # contention freeze at start (see module docstring)
        contention = max(1.0, self._active_utilization() + job.utilization)
        # paging transfers delay the affected job's next iteration
        dur = (
            job.iter_time * contention
            + overhead
            + self._transfer_delay.pop(job.job_id, 0.0)
        )
        start = now
        end = now + dur
        # Solo fast-forward: a closed-loop job that is the device's only
        # resident runs its iterations back to back — every boundary tick
        # is a no-op (nothing queued, nothing paged) and every policy
        # re-picks the lone candidate. Commit those iterations inline
        # instead of round-tripping each through the heap, stopping
        # strictly before the next queued event (an arrival changes the
        # candidate set; ties stay on the slow path so batch ordering is
        # untouched) and at the advance() horizon. The last remaining
        # iteration is always pushed as a real event so FINISHED/job_finish
        # machinery runs on the normal path. Each committed iteration does
        # exactly the bookkeeping _handle's iter_done branch would —
        # identical floats, records, and stats — so engine differentials
        # are unaffected; this is a constant-factor cut for the
        # million-job sweep, where 1-3-iteration solo jobs dominate.
        reg = self.registry
        st_jobs = job.n_iters
        if (
            st.iterations_done + 1 < st_jobs
            and job.request_times is None
            and not reg.queue
            and not reg.paged
            and len(reg.assignment) == 1
            and not self._running_iter
        ):
            q = self._q
            t_next = q.peek_time()
            hz = self._horizon
            # steady-state duration at each subsequent boundary: same job
            # (no switch), sole runner (contention = max(1, u)), no
            # pending transfer — exactly what _schedule would recompute
            dur_steady = job.iter_time * max(1.0, job.utilization)
            records = self._records
            jid, lane_id = job.job_id, lane.lane_id
            while (
                st.iterations_done + 1 < st_jobs
                and (t_next is None or end < t_next)
                and (hz is None or end <= hz)
            ):
                st.iterations_done += 1
                st.service_time += end - start
                st.last_run_end = end
                records.append(
                    IterationRecord(jid, st.iterations_done - 1, start, end, lane_id)
                )
                self._last_ran = jid
                start = end
                end = start + dur_steady
        self._running_iter[lane.lane_id] = (job, start)
        self._q.push(end, "iter_done", job)

    def _schedule(self) -> None:
        """Fill idle lanes (or the idle device, for exclusive policies)."""
        reg, policy = self.registry, self.policy
        now = self._q.now
        if policy.exclusive:
            if self._running_iter:
                # iteration-granularity preemption: let it finish
                return
            ready = [
                j for lane in reg.lanes.values() for j in self._candidates_in(lane)
            ]
            if not ready:
                # nothing runnable: same outcome as a None pick, without
                # paying the select call on every idle wake-up
                self._last_ran = None
                return
            job = policy.select(
                ready, self._stats, now, blocked=frozenset(reg.paged)
            )
            if job is not None:
                lane = reg.assignment[job.job_id]
                # genuine preemption = running -> paused displacement:
                # only the job whose iteration just ended, still wanting
                # the device (it is a candidate), loses the pick to
                # another job. Bystanders merely waiting their turn are
                # not preempted and stay READY.
                prev = self._last_ran
                if (
                    prev is not None
                    and prev != job.job_id
                    and any(o.job_id == prev for o in ready)
                ):
                    self._state[prev] = JobState.PAUSED
                    self._stats[prev].preemptions += 1
                self._start_iteration(lane, job)
            else:
                # device going idle: the previous runner yielded with
                # nothing runnable, so whatever runs after the gap
                # displaces no one
                self._last_ran = None
            return
        blocked = frozenset(reg.paged)
        for lane in list(reg.lanes.values()):
            if lane.lane_id in self._running_iter:
                continue
            cands = self._candidates_in(lane)
            if not cands:
                continue
            job = policy.select(cands, self._stats, now, blocked=blocked)
            if job is not None:
                self._start_iteration(lane, job)

    def _idle_ticks(self, live: bool) -> None:
        """Idle boundary ticks: if nothing is in flight the ephemeral region
        is empty device-wide, so admission/paging may proceed right now
        instead of waiting for an iteration to end (open-loop gaps would
        otherwise strand queued/paged jobs). The executor's idle branch runs
        the exact same tick-until-quiescent loop. Skipped at stale-request
        instants the executor never visits."""
        reg, mm = self.registry, self.memory
        now = self._q.now
        while (
            live
            and not self._running_iter
            and (reg.queue or reg.paged)
            and mm.iteration_boundary(now, self._busy())
        ):
            self._schedule()

    def _on_admit(self, job: JobSpec, lane: Lane) -> None:
        st = self._stats[job.job_id]
        if st.admit_time is None:
            st.admit_time = self._q.now
        self._state[job.job_id] = JobState.READY
        # the admission waited on any page-outs that freed its bytes
        if self._pending_out_cost:
            self._transfer_delay[job.job_id] = (
                self._transfer_delay.get(job.job_id, 0.0) + self._pending_out_cost
            )
            self._pending_out_cost = 0.0

    def _on_mem_event(self, ev: MemoryEvent) -> None:
        if ev.kind is MemoryEventKind.PAGE_OUT:
            self._state[ev.job_id] = JobState.PAGED
            self._stats[ev.job_id].page_outs += 1
            self._stats[ev.job_id].transfer_time += ev.cost
            self._pending_out_cost += ev.cost
        elif ev.kind is MemoryEventKind.PAGE_IN:
            self._state[ev.job_id] = JobState.READY
            self._stats[ev.job_id].page_ins += 1
            self._stats[ev.job_id].transfer_time += ev.cost
            self._transfer_delay[ev.job_id] = (
                self._transfer_delay.get(ev.job_id, 0.0) + ev.cost
            )
        elif ev.kind is MemoryEventKind.REJECT:
            self._stats[ev.job_id].rejected = True
            self._state[ev.job_id] = JobState.FINISHED
        elif ev.kind is MemoryEventKind.SECOND_CHANCE:
            self._stats[ev.job_id].second_chances = self.memory.chances.get(
                ev.job_id, 0
            )
        else:
            # explicit default (RPL010): ADMIT / QUEUE / LANE_MOVED carry no
            # stats or state change here — admission state is applied by the
            # on_admit callback, queueing leaves the job QUEUED as-is; no
            # MIGRATE_* event arises without the migration surface
            assert ev.kind in (
                MemoryEventKind.ADMIT,
                MemoryEventKind.QUEUE,
                MemoryEventKind.LANE_MOVED,
            ), ev.kind

    def _handle(self, ev: Event) -> bool:
        """Process one event. Returns False for *stale* events — wake-ups
        that cannot change runnability (a request whose service is finished
        or backlogged so its head request already arrived). Stale events must not trigger idle
        boundary ticks: the executor only visits head-of-queue request
        instants (``_next_request_time``), and tick counts feed
        deficit/chances accounting, so an extra tick here would fork the
        two engines' decision sequences."""
        t, _seq, kind, job, _gen = ev
        now = self._q.now
        if kind == "arrival":
            # may admit (on_admit fires)
            self.memory.job_arrive(job, now, self._busy())
        elif kind == "request":
            if self._state[job.job_id] is JobState.FINISHED:
                return False
            nxt = job.next_request_time(
                self._stats[job.job_id].iterations_done
            )
            return nxt is not None and max(nxt, job.arrival_time) == t
        elif kind == "iter_done":
            lane = self.registry.assignment[job.job_id]
            j, start = self._running_iter.pop(lane.lane_id)
            assert j is job
            st = self._stats[job.job_id]
            st.iterations_done += 1
            st.service_time += now - start
            st.last_run_end = now
            if job.request_times is not None:
                # request latency = completion - request arrival
                # (queueing + service, the Fig. 9/10 SLO metric)
                st.request_latencies.append(
                    now - job.request_times[st.iterations_done - 1]
                )
            self._records.append(
                IterationRecord(
                    job.job_id, st.iterations_done - 1, start, now, lane.lane_id
                )
            )
            # one busy snapshot serves both calls: neither job_finish nor
            # any admission it triggers changes the set of in-flight jobs
            busy = self._busy()
            if st.iterations_done >= job.n_iters:
                self._state[job.job_id] = JobState.FINISHED
                st.finish_time = now
                self._last_ran = None
                # frees lane / admits queued
                self.memory.job_finish(job, now, busy)
            else:
                self._state[job.job_id] = JobState.READY
                self._last_ran = job.job_id
            # second-chance tick: re-admit / page at the boundary
            self.memory.iteration_boundary(now, busy)
        return True
