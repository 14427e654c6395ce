"""SalusExecutor: the consolidated execution service, live on real devices.

Single-process, owns the device; sessions register (1a), get a lane from
the memory manager (1b), and their iterations are scheduled (2a/2b) at
iteration granularity by the configured policy. Persistent state (param
arrays) never leaves the device between switches — switching cost is just
dispatching a different executable, measured and reported.

Memory admission goes through the shared :class:`MemoryManager` (the same
decision logic, verbatim, that the discrete-event simulator runs): deficit
admission control, second-chance retries at iteration boundaries, and —
when paging is enabled — real host round-trips of a session's persistent
tensors (pinned host copies and back to the executor's device) when
ephemeral pressure forces a victim's P off-device.

On a one-core host, cross-lane parallelism is time-multiplexed dispatch
(DESIGN.md §2); the executor interleaves lanes round-robin, one iteration
per turn, which preserves the serialization-within-lane invariant.

``accounting``:
  * ``"wall"`` (default) — policy-visible service times are measured
    wall-clock, the live-serving behavior.
  * ``"nominal"`` — policy-visible service accrues the job's *declared*
    ``iter_time`` per iteration instead of the measured duration. Wall
    times are still measured and reported (records, JCTs); only scheduling
    decisions use nominal time. This makes the decision sequence a pure
    function of the trace — the property the simulator<->executor
    differential suite locks down (timing noise cannot flip near-tie
    policy comparisons).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

from repro_torch.core.engine import DecisionLog, ResultSurface
from repro_torch.core.lanes import Lane, LaneRegistry
from repro_torch.core.memory import MemoryConfig, MemoryManager
from repro_torch.core.scheduler import Policy, get_policy
from repro_torch.core.session import Session, synchronize
from repro_torch.core.types import (
    IterationRecord,
    JobSpec,
    JobState,
    JobStats,
    MemoryEvent,
    MemoryEventKind,
)


@dataclass
class ExecutorReport(ResultSurface):
    stats: Dict[int, JobStats]
    records: List[IterationRecord]
    makespan: float
    switch_latencies: List[float]
    registry_stats: Dict
    transfer_latencies: List[float] = field(default_factory=list)
    memory_events: List[MemoryEvent] = field(default_factory=list)
    decision_log: DecisionLog = field(default_factory=DecisionLog)
    failures: Dict[int, str] = field(default_factory=dict)  # job_id -> error

    # avg_jct / p95_jct / jcts / utilization / completed / per_job /
    # request_latencies come from ResultSurface.


class SalusExecutor:
    def __init__(
        self,
        capacity: int,
        policy: Policy,
        memory: Optional[MemoryConfig] = None,
        accounting: str = "wall",
        *,
        device: Any,
    ) -> None:
        if accounting not in ("wall", "nominal"):
            raise ValueError(f"accounting must be wall|nominal, got {accounting!r}")
        # the torch device this executor owns: paged-in and migrated-in
        # state lands here, and sessions synchronize on it
        self.device = torch.device(device)
        self.registry = LaneRegistry(capacity)
        self.memory = MemoryManager(self.registry, memory, pager=self._do_transfer)
        self.memory.on_admit = self._on_admit
        self.memory.on_event = self._on_mem_event
        self.policy = get_policy(policy)
        self.accounting = accounting
        self.sessions: Dict[int, Session] = {}
        self.stats: Dict[int, JobStats] = {}
        self.state: Dict[int, JobState] = {}
        self.records: List[IterationRecord] = []
        self.switch_latencies: List[float] = []
        self.transfer_latencies: List[float] = []
        self.failures: Dict[int, str] = {}  # job_id -> "ExcType: message"
        self._last_job_on: Dict[int, int] = {}
        self._last_ran: Optional[int] = None  # job whose iteration just ended
        self._t0: Optional[float] = None
        # Nominal virtual clock: replicates the simulator's time semantics
        # (declared iteration times + modeled transfer charging + jumps to
        # the next open-loop request arrival) so request gating under
        # accounting="nominal" is a pure function of the trace — the
        # property the differential suite compares against virtual time.
        self._vnow = 0.0
        self._vtransfer: Dict[int, float] = {}  # job_id -> pending modeled delay
        self._vpending_out = 0.0  # modeled page-out time owed by next admission
        self._wall_base: Optional[float] = None  # wall clock at run() entry

    # ------------------------------------------------------------------

    def now(self) -> float:
        if self._t0 is None:
            self._t0 = time.perf_counter()
        return time.perf_counter() - self._t0

    def _clock(self) -> float:
        """The clock open-loop request gating runs against: virtual under
        nominal accounting (mirrors the simulator), wall otherwise. Wall
        time is measured from run() entry, not first submit — session
        creation (jit compiles) must not eat into the request window."""
        if self.accounting == "nominal":
            return self._vnow
        return self.now() - (self._wall_base or 0.0)

    def submit(self, session: Session) -> None:
        """(1a) create session + (1b) request a lane (may queue). Raises on
        a duplicate ``job_id``: JobSpec equality/hashing key on the id, so a
        second spec sharing one would silently replace the first in every
        per-job dict (sessions, stats, registry assignment)."""
        job = session.job
        if job.job_id in self.sessions:
            raise ValueError(
                f"duplicate job_id {job.job_id} ({job.name!r}): already submitted"
            )
        self.sessions[job.job_id] = session
        self.stats[job.job_id] = JobStats(arrival_time=self.now())
        self.state[job.job_id] = JobState.QUEUED
        self.memory.job_arrive(job, self.now())

    # ------------------------------------------------------------------
    # Memory-manager hooks (the live side of the shared decision core)
    # ------------------------------------------------------------------

    def _to_host(self, t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        host = torch.empty(
            t.shape, dtype=t.dtype, pin_memory=self.device.type == "cuda"
        )
        host.copy_(t, non_blocking=True)
        return host

    def _to_device(self, t: Any) -> Any:
        if not isinstance(t, torch.Tensor):
            return t
        return t.to(self.device, non_blocking=True)

    def _do_transfer(self, direction: str, job: JobSpec) -> float:
        """Really move the session's persistent tensors across the host
        link. Page-out copies each tensor into pinned host memory; page-in
        copies it back to the executor's device. Both wait for the copies,
        and replacing ``sess.state`` drops the only references to the old
        tensors, so the caching allocator can hand their bytes to other
        sessions."""
        sess = self.sessions.get(job.job_id)
        t0 = time.perf_counter()
        if sess is not None:
            move = self._to_host if direction == "out" else self._to_device
            sess.state = pytree.tree_map(move, sess.state)
            synchronize(self.device)
        dt = time.perf_counter() - t0
        self.transfer_latencies.append(dt)
        return dt

    def _modeled_cost(self, job: JobSpec) -> float:
        """The simulator's transfer model (P / page_bandwidth), tracked in
        parallel with the real pager so the nominal clock charges the exact
        delays the simulator's virtual clock does."""
        return job.profile.persistent / self.memory.config.page_bandwidth

    def _on_admit(self, job: JobSpec, lane: Lane) -> None:
        st = self.stats[job.job_id]
        if st.admit_time is None:
            st.admit_time = self.now()
        self.state[job.job_id] = JobState.READY
        # the admission waited on any page-outs that freed its bytes
        if self._vpending_out:
            self._vtransfer[job.job_id] = (
                self._vtransfer.get(job.job_id, 0.0) + self._vpending_out
            )
            self._vpending_out = 0.0

    def _on_mem_event(self, ev: MemoryEvent) -> None:
        if ev.kind is MemoryEventKind.PAGE_OUT:
            self.state[ev.job_id] = JobState.PAGED
            self.stats[ev.job_id].page_outs += 1
            self.stats[ev.job_id].transfer_time += ev.cost
            self._vpending_out += self._modeled_cost(ev.job)
        elif ev.kind is MemoryEventKind.PAGE_IN:
            self.state[ev.job_id] = JobState.READY
            self.stats[ev.job_id].page_ins += 1
            self.stats[ev.job_id].transfer_time += ev.cost
            self._vtransfer[ev.job_id] = (
                self._vtransfer.get(ev.job_id, 0.0) + self._modeled_cost(ev.job)
            )
        elif ev.kind is MemoryEventKind.REJECT:
            self.stats[ev.job_id].rejected = True
            self.state[ev.job_id] = JobState.FINISHED
        elif ev.kind is MemoryEventKind.SECOND_CHANCE:
            self.stats[ev.job_id].second_chances = self.memory.chances.get(
                ev.job_id, 0
            )
        elif ev.kind is MemoryEventKind.MIGRATE_OUT:
            # stats still present (migrate_out pops them after the mm call);
            # the nominal-clock charge travels via migrate_out's return value
            self.stats[ev.job_id].transfer_time += ev.cost
        elif ev.kind is MemoryEventKind.MIGRATE_IN:
            self.stats[ev.job_id].transfer_time += ev.cost
            # nominal clock charges the *modeled* in-cost, mirroring the
            # simulator's transfer_delay (same pattern as PAGE_IN)
            self._vtransfer[ev.job_id] = (
                self._vtransfer.get(ev.job_id, 0.0) + self._modeled_cost(ev.job)
            )
        else:
            # explicit default (RPL010): ADMIT / QUEUE / LANE_MOVED carry no
            # stats or state change here — mirrors the simulator branch for
            # branch-for-branch parity (RPL020)
            assert ev.kind in (
                MemoryEventKind.ADMIT,
                MemoryEventKind.QUEUE,
                MemoryEventKind.LANE_MOVED,
            ), ev.kind

    # ------------------------------------------------------------------

    def _candidates(self, lane: Lane) -> List[JobSpec]:
        clock = self._clock()
        return [
            j
            for j in lane.jobs
            if self.state[j.job_id] in (JobState.READY, JobState.PAUSED)
            and j.request_pending(self.stats[j.job_id].iterations_done, clock)
        ]

    def _run_one(self, lane: Lane, job: JobSpec) -> None:
        t_enter = time.perf_counter()
        sess = self.sessions[job.job_id]
        st = self.stats[job.job_id]
        now = self.now()
        if st.first_run_time is None:
            st.first_run_time = now
        prev = self._last_job_on.get(lane.lane_id)
        self._last_job_on[lane.lane_id] = job.job_id
        self.state[job.job_id] = JobState.RUNNING
        if prev is not None and prev != job.job_id:
            # fast-switch cost: executor bookkeeping + dispatch setup between
            # the scheduling decision and the step launch. Persistent memory
            # stayed resident, so there is NO checkpoint transfer component
            # (contrast: bench_switching computes the Gandiva-style transfer
            # lower bound for the same jobs).
            self.switch_latencies.append(time.perf_counter() - t_enter)
        try:
            dur = sess.run_iteration(st.iterations_done)
        except Exception as exc:  # noqa: BLE001 — any step_fn/data_fn error
            # A failing session must not abort the run with its lane still
            # allocated: mark it terminally failed, free the lane through
            # the memory manager (queued jobs get their admission retry),
            # and surface the error in the report.
            self.state[job.job_id] = JobState.FAILED
            st.failed = True
            self.failures[job.job_id] = f"{type(exc).__name__}: {exc}"
            self._last_ran = None
            self.memory.job_finish(job, self._clock())
            return
        end = self.now()
        st.iterations_done += 1
        if self.accounting == "wall":
            st.service_time += dur
        else:
            st.service_time += job.iter_time
            # virtual clock: declared duration + any modeled paging delay
            # charged to this job (mirrors the simulator's start_iteration)
            self._vnow += job.iter_time + self._vtransfer.pop(job.job_id, 0.0)
        st.last_run_end = self._clock()
        if job.request_times is not None:
            st.request_latencies.append(
                self._clock() - job.request_times[st.iterations_done - 1]
            )
        self.records.append(
            IterationRecord(job.job_id, st.iterations_done - 1, end - dur, end, lane.lane_id)
        )
        if sess.finished:
            self.state[job.job_id] = JobState.FINISHED
            st.finish_time = end
            self._last_ran = None
            self.memory.job_finish(job, self._clock())
        else:
            self.state[job.job_id] = JobState.READY
            self._last_ran = job.job_id
        # second-chance tick: between iterations the ephemeral region is
        # empty, so pending jobs may be re-admitted and P pages may move
        # (memory-event stamps use the same clock request gating does)
        self.memory.iteration_boundary(self._clock())

    def _done(self) -> bool:
        return all(
            s in (JobState.FINISHED, JobState.FAILED) or self.sessions[j].finished
            for j, s in self.state.items()
        )

    def _next_request_time(self) -> Optional[float]:
        """Earliest future open-loop request arrival among live jobs, or
        None. Used when the device idles: the nominal clock jumps there
        (the simulator pops the matching request event), the wall clock
        sleeps until it."""
        clock = self._clock()
        best = None
        for jid, s in self.state.items():
            if s in (JobState.FINISHED, JobState.FAILED):
                continue
            nxt = self.sessions[jid].job.next_request_time(
                self.stats[jid].iterations_done
            )
            if nxt is not None and nxt > clock and (best is None or nxt < best):
                best = nxt
        return best

    # ------------------------------------------------------------------
    # Migration surface (driven by ClusterExecutor at epoch boundaries)
    # ------------------------------------------------------------------

    def migrate_out(self, job_id: int) -> Tuple[Session, JobStats, float]:
        """Remove a session from this device for migration: the memory
        manager logs MIGRATE_OUT and (for resident jobs) really pages the
        session's persistent tensors to host via the pager. Returns the
        session, its stats (carried to the destination), and the *modeled*
        pending delay the destination's nominal clock must charge — the
        mirror of ``Simulator.migrate_out``'s return."""
        sess = self.sessions[job_id]
        job = sess.job
        if self.state.get(job_id) is JobState.RUNNING:
            raise RuntimeError(
                f"migrate_out of RUNNING job {job.name}: migrations happen at "
                "iteration boundaries only"
            )
        resident = (
            job_id in self.registry.assignment and job_id not in self.registry.paged
        )
        self.memory.migrate_out(job, self._clock())  # pager moves state to host
        st = self.stats.pop(job_id)
        self.sessions.pop(job_id)
        self.state.pop(job_id)
        carry = self._vtransfer.pop(job_id, 0.0)
        if self._last_ran == job_id:
            self._last_ran = None
        modeled = self._modeled_cost(job) if resident else 0.0
        return sess, st, modeled + carry

    def migrate_in(
        self,
        session: Session,
        st: JobStats,
        extra_delay: float = 0.0,
        put_fn: Optional[Callable] = None,
    ) -> None:
        """Land a migrated session here: really move its host-side state
        back onto this executor's device (``put_fn`` defaults to a copy of
        every tensor to ``self.device``, the page-in path; a mesh-aware
        restore that re-shards onto another device layout plugs in here),
        then run the ordinary admission path. ``extra_delay`` is the source-side modeled
        cost from ``migrate_out``, charged to the nominal clock before this
        job's first iteration here."""
        job = session.job
        jid = job.job_id
        self.sessions[jid] = session
        self.stats[jid] = st
        self.state[jid] = JobState.QUEUED
        if extra_delay:
            self._vtransfer[jid] = self._vtransfer.get(jid, 0.0) + extra_delay
        cost = None
        if session.state is not None:
            t0 = time.perf_counter()
            put = put_fn or (lambda tree: pytree.tree_map(self._to_device, tree))
            session.state = put(session.state)
            synchronize(self.device)
            cost = time.perf_counter() - t0
            self.transfer_latencies.append(cost)
        # logs MIGRATE_IN (the on-event hook charges the modeled in-cost to
        # the nominal clock), then admission: admit / queue / reject
        self.memory.migrate_in(job, self._clock(), cost=cost)

    # ------------------------------------------------------------------

    def run(self, max_wall: Optional[float] = None) -> ExecutorReport:
        """Drive all submitted sessions to completion."""
        self._drive(until=None, max_wall=max_wall)
        return self.report()

    def run_epoch(self, until: float, max_wall: Optional[float] = None) -> int:
        """Drive until the epoch horizon: iterations may *start* while the
        scheduling clock is <= ``until`` (the crossing iteration completes —
        the device always stops quiescent, which is what makes migration at
        the boundary safe). Returns the number of iterations executed, the
        fleet driver's progress signal. Unlike ``run``, a device left with
        nothing runnable before the horizon simply returns — queued work may
        be waiting on a migration another device will feed it."""
        return self._drive(until=until, max_wall=max_wall)

    def _drive(self, until: Optional[float], max_wall: Optional[float]) -> int:
        if self._wall_base is None:
            self._wall_base = self.now()
        blocked = lambda: frozenset(self.registry.paged)
        progress = 0
        while until is None or self._clock() <= until:
            # max_wall is measured from run() entry: session creation (jit
            # compiles after the first submit) must not consume the budget
            if max_wall is not None and self.now() - self._wall_base > max_wall:
                break
            progressed = False
            if self.policy.exclusive:
                ready = [
                    j for lane in self.registry.lanes.values() for j in self._candidates(lane)
                ]
                # decisions run on _clock() so FAIR rates and PRIORITY aging
                # compare trace-relative arrival/last-run times against a
                # clock in the same domain (virtual under nominal, wall from
                # run() entry otherwise)
                job = self.policy.select(ready, self.stats, self._clock(), blocked=blocked())
                if job is not None:
                    # genuine preemption only: the job whose iteration just
                    # ended, still a candidate, displaced by another pick
                    # (mirrors the simulator's exclusive schedule() branch)
                    prev = self._last_ran
                    if (
                        prev is not None
                        and prev != job.job_id
                        and any(o.job_id == prev for o in ready)
                    ):
                        self.state[prev] = JobState.PAUSED
                        self.stats[prev].preemptions += 1
                    self._run_one(self.registry.assignment[job.job_id], job)
                    progressed = True
                    progress += 1
            else:
                # round-robin across lanes: one iteration per lane per sweep
                for lane in list(self.registry.lanes.values()):
                    if lane.lane_id not in self.registry.lanes:
                        continue  # lane deleted by a finish earlier this sweep
                    job = self.policy.select(
                        self._candidates(lane), self.stats, self._clock(), blocked=blocked()
                    )
                    if job is not None:
                        self._run_one(lane, job)
                        progressed = True
                        progress += 1
            if not progressed:
                # device going idle: whatever runs after the gap displaces
                # no one (mirrors the simulator's exclusive schedule())
                self._last_ran = None
                if self._done():
                    break
                # one more boundary tick: paging / second chance may unblock
                # (the simulator runs the identical tick loop whenever its
                # device goes idle with queued/paged jobs)
                if self.memory.iteration_boundary(self._clock()):
                    continue
                # open-loop gap: nothing runnable until the next request
                # arrives — jump the virtual clock (nominal) or really wait
                # for it (wall), then rescan. With an epoch horizon, only
                # jump to requests inside it (the simulator likewise leaves
                # post-horizon events for the next advance)
                nxt = self._next_request_time()
                if nxt is not None and (until is None or nxt <= until):
                    if self.accounting == "nominal":
                        self._vnow = nxt
                    else:
                        time.sleep(max(0.0, nxt - self._clock()))
                    continue
                if until is not None:
                    # epoch horizon: nothing runnable before it — hand back
                    # to the fleet driver (queued work may be waiting on a
                    # migration from another device, not deadlocked)
                    break
                if self.registry.queue or self.registry.paged:
                    # pending jobs that can never fit => deadlock guard
                    raise RuntimeError(
                        f"stalled: {len(self.registry.queue)} queued, "
                        f"{len(self.registry.paged)} paged out, none runnable"
                    )
                break
        if until is not None and self.accounting == "nominal":
            # mirror the simulator clamping its clock to the epoch horizon
            self._vnow = max(self._vnow, until)
        return progress

    def report(self) -> ExecutorReport:
        """Snapshot the run into an :class:`ExecutorReport` (idempotent)."""
        for jid, st in self.stats.items():
            st.second_chances = max(st.second_chances, self.memory.chances.get(jid, 0))
        makespan = self.now()
        return ExecutorReport(
            self.stats,
            self.records,
            makespan,
            self.switch_latencies,
            self.memory.stats(),
            transfer_latencies=self.transfer_latencies,
            memory_events=self.memory.events,
            decision_log=DecisionLog(self.memory.decision_log()),
            failures=dict(self.failures),
        )

    # Engine-protocol accessors -----------------------------------------

    def result(self) -> ExecutorReport:
        return self.report()

    def decision_log(self) -> List[tuple]:
        return self.memory.decision_log()

    def done(self) -> bool:
        """All submitted sessions terminal (finished or failed)."""
        return self._done()
