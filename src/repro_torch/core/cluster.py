"""Cluster-scale Salus: a fleet of per-device engines behind placement. The
port's copy of the JAX package's ``core/cluster.py``; its one binding to a
framework, the live executors' devices, is a torch device here.

The paper's headline numbers (§5.1, Fig. 5/6) come from a *cluster*
regime: a fleet scheduler places jobs onto GPUs and Salus time-shares
each GPU. :class:`Cluster` owns N per-device :class:`Simulator` instances
— each with its own :class:`LaneRegistry` + :class:`MemoryManager` +
policy — behind a :class:`Placer` (see :mod:`repro_torch.core.placement` for
the LEAST_LOADED / BEST_FIT / CONSOLIDATE strategies and the
deficit-ordered queue-and-retry). :class:`ClusterExecutor` is the live
mirror: N :class:`SalusExecutor` instances driven per-device by the same
placement decisions (the placer only reads :class:`JobSpec`s, so the
plan is engine-agnostic).

An N=1 cluster is bitwise-identical to a bare single-device engine on
the same trace: placement binds every job to device 0 with its original
arrival time, and the device engine replays exactly the single-device
decision sequence (locked by ``tests/test_differential.py``).

**Rebalance epochs** (``rebalance_interval=T``): the fleet is driven in
lockstep epochs instead of device-at-a-time. Every T scheduling-clock
seconds each device advances to the horizon and drains its in-flight
iterations (both engines stop *quiescent* — ephemeral regions empty, the
iteration boundary where migration is safe), then a
:class:`~repro_torch.core.placement.Rebalancer` snapshots the devices into
engine-agnostic views and decides :class:`Migration`s. Applying one
composes the primitives end-to-end: ``migrate_out`` on the source
(page-out-style release through the shared :class:`MemoryManager`, which
logs MIGRATE_OUT and — in the live engine — really moves the session's
persistent arrays to host) then ``migrate_in`` on the destination
(MIGRATE_IN + the ordinary admission path; the live engine really copies
the state back to its device). Transfer costs (P/page_bandwidth
modeled; measured wall reported) are charged to the migrated job's next
iteration, so migration is never free. A
:class:`~repro_torch.dist.fault.FailureInjector` may fire between the out and
in halves; the driver then rolls the job back onto its source
(conservation: a job is never lost mid-migration) and logs
MIGRATE_FAILED. Finally jobs *bound but not yet arrived* are re-placed
against the post-migration fleet (placement is a-priori; the amendment
pass is what lets consolidation actually shrink ``devices_used``).
``rebalance_interval=None`` (default) runs each device to the end in turn.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.core.engine import DecisionLog, ResultSurface, busy_seconds
from repro_torch.core.events import EpochSchedule
from repro_torch.core.fleet import FleetDriver
from repro_torch.core.memory import MemoryConfig
from repro_torch.core.placement import (
    DeviceView,
    JobView,
    Migration,
    Placer,
    PlacementEvent,
    PlacementEventKind,
    PlacementPlan,
    PlacementStrategy,
    Rebalancer,
)
from repro_torch.core.scheduler import Policy, get_policy
from repro_torch.core.simulator import SimResult, Simulator
from repro_torch.core.types import (
    IterationRecord,
    JobSpec,
    JobState,
    JobStats,
)
from repro_torch.dist.fault import InjectedFailure, StragglerMonitor

if TYPE_CHECKING:
    import torch

    from repro_torch.core.executor import ExecutorReport

_TERMINAL = (JobState.FINISHED, JobState.FAILED, JobState.CANCELLED)


@dataclass
class EpochSnapshot:
    """Quiescent-boundary view of a fleet run, handed to the ``on_epoch``
    callback after each rebalance pass. ``progress``/``states`` cover every
    job still bound to a device (jobs evicted at an earlier boundary are
    gone — their final stats were returned by the eviction). The logs are
    the *full* fleet decision sequences so far; a durable consumer (a
    control plane's store) keeps its own committed offsets and appends the
    suffix."""

    time: float  # scheduling-clock epoch boundary
    progress: Dict[int, int]  # job_id -> iterations_done
    states: Dict[int, "JobState"]
    placement_log: List[tuple]  # plan.decision_log() so far
    device_logs: List[List[tuple]]  # per-device memory decision logs so far
    # in-engine rejections (P + E > C): engine-side state is FINISHED with
    # stats.rejected set; consumers needing the distinction read this
    rejected: frozenset = frozenset()


class EpochControl:
    """Control-plane handle valid only inside one ``on_epoch`` call, while
    the fleet is quiescent (in-flight iterations drained — the same safe
    point migrations use). ``evict`` pulls a job off the fleet keeping its
    progress (a control-plane pause/requeue); ``cancel`` terminates it in
    place (stats stay on its device with ``finish_time`` None, so cancelled
    jobs never count as completed)."""

    def __init__(self, sims: List[Simulator], plan: PlacementPlan, t: float) -> None:
        self._sims = sims
        self._plan = plan
        self._t = t

    def _locate(self, job_id: int) -> int:
        dev = self._plan.assignments.get(job_id)
        if dev is not None and job_id in self._sims[dev]._jobs:
            return dev
        for i, sim in enumerate(self._sims):
            if job_id in sim._jobs:  # rejected jobs routed to the sink
                return i
        raise KeyError(f"job {job_id} is not bound to any device")

    def state(self, job_id: int) -> JobState:
        return self._sims[self._locate(job_id)]._state[job_id]

    def _log(self, kind: PlacementEventKind, job: JobSpec, src: int) -> None:
        self._plan.events.append(
            PlacementEvent(
                kind, self._t, self._plan.order.get(job.job_id, -1),
                job.name, None, src_device_id=src,
            )
        )

    def evict(self, job_id: int) -> tuple:
        """Pull a non-terminal job off the fleet, returning ``(spec,
        stats)`` — its iterations_done is the boundary a later resubmission
        resumes from (``Cluster.run(resume_done=...)``)."""
        dev = self._locate(job_id)
        sim = self._sims[dev]
        job = sim._jobs[job_id]
        if sim._state.get(job_id) in _TERMINAL:
            raise RuntimeError(f"evict of terminal job {job.name}")
        if sim.has_arrived(job_id):
            st, _carry = sim.migrate_out(job)
        else:
            st = sim._stats[job_id]
            sim.remove_pending(job)
        self._plan.assignments.pop(job_id, None)
        self._log(PlacementEventKind.EVICT, job, dev)
        return job, st

    def cancel(self, job_id: int) -> tuple:
        """Terminally cancel a job in place (lane freed, stats kept on its
        device). Returns ``(spec, stats)``."""
        dev = self._locate(job_id)
        sim = self._sims[dev]
        job = sim._jobs[job_id]
        st = sim.cancel(job)
        self._log(PlacementEventKind.CANCEL, job, dev)
        return job, st


@dataclass
class ClusterResult(ResultSurface):
    """Aggregation of per-device :class:`SimResult`s plus the placement
    decision log (fleet avg/p95 JCT, per-device utilization). Mixes in the
    unified :class:`ResultSurface` accessors; ``utilization`` is the mean
    of per-device busy fractions (a union across devices is meaningless)."""

    device_results: List[SimResult]
    plan: PlacementPlan
    jobs: Dict[int, JobSpec] = field(default_factory=dict)
    migrations: List[Migration] = field(default_factory=list)

    # -- fleet-wide aggregation ----------------------------------------

    @property
    def stats(self) -> Dict[int, JobStats]:
        out: Dict[int, JobStats] = {}
        for res in self.device_results:
            out.update(res.stats)
        return out

    @property
    def records(self) -> List[IterationRecord]:
        return [r for res in self.device_results for r in res.records]

    @property
    def makespan(self) -> float:
        return max((r.makespan for r in self.device_results), default=0.0)

    @property
    def devices_used(self) -> int:
        return sum(1 for r in self.device_results if r.records)

    @property
    def per_device_utilization(self) -> List[float]:
        """Busy fraction of each device over the fleet makespan."""
        span = self.makespan
        if span <= 0.0:
            return [0.0 for _ in self.device_results]
        return [busy_seconds(r.records) / span for r in self.device_results]

    @property
    def utilization(self) -> float:
        per = self.per_device_utilization
        return sum(per) / len(per) if per else 0.0

    @property
    def decision_log(self) -> DecisionLog:
        """The fleet-level decision sequence is the placement log (each
        device result carries its own memory-manager log). A
        :class:`DecisionLog` both compares as a list and is callable."""
        return DecisionLog(self.plan.decision_log())

    def placement_log(self) -> List[tuple]:
        return self.plan.decision_log()

    def migration_log(self) -> List[tuple]:
        return self.plan.migration_log()

    def summary(self) -> Dict:
        placed = len(self.plan.assignments)
        queued = sum(
            1 for e in self.plan.events if e.kind.value == "queue"
        )
        return {
            "n_devices": self.plan.n_devices,
            "devices_used": self.devices_used,
            "makespan": self.makespan,
            "avg_jct": self.avg_jct,
            "p95_jct": self.p95_jct,
            "n_jobs": placed + len(self.plan.rejected),
            "placed": placed,
            "queued_at_placement": queued,
            # device-level rejects are exactly the routed cluster rejects
            # (a placed job always has P + E <= its device's capacity)
            "rejected": len(self.plan.rejected),
            "completed": self.completed,
            "migrations": len(self.migrations),
            "per_device_utilization": self.per_device_utilization,
            "per_device_jobs": [len(r.stats) for r in self.device_results],
        }


class _RebalanceMixin:
    """Fleet-driver machinery shared by :class:`Cluster` and
    :class:`ClusterExecutor`: rebalancer wiring, migration application
    with failure rollback, and the migration event log."""

    def _init_rebalance(
        self,
        rebalancer: Optional[Rebalancer],
        rebalance_interval: Union[float, EpochSchedule, None],
        fault_injector: Optional[Any],
    ) -> None:
        schedule: Optional[EpochSchedule]
        if isinstance(rebalance_interval, EpochSchedule):
            # the ctl daemon hands its commit cadence in directly, so the
            # event-core schedule that drives on_epoch is the same object
            # the engine's epoch loop consumes
            schedule = rebalance_interval
        elif rebalance_interval is not None:
            if rebalance_interval <= 0:
                raise ValueError(
                    f"rebalance_interval must be positive, got {rebalance_interval}"
                )
            schedule = EpochSchedule(rebalance_interval)
        else:
            schedule = None
        if rebalancer is not None and schedule is None:
            raise ValueError("a rebalancer needs rebalance_interval to ever run")
        if schedule is not None and rebalancer is None:
            rebalancer = Rebalancer()
        self.rebalancer = rebalancer
        self.rebalance_schedule = schedule
        self.rebalance_interval = None if schedule is None else schedule.interval
        self.fault_injector = fault_injector
        self._mig_seq = 0

    def _log_migration(
        self, plan: PlacementPlan, kind: PlacementEventKind, t: float, m: Migration, dst: int
    ) -> None:
        plan.events.append(
            PlacementEvent(
                kind, t, plan.order.get(m.job_id, -1), m.name, dst,
                src_device_id=m.src,
            )
        )


class Cluster(_RebalanceMixin):
    """N per-device Simulators behind a placement policy (an
    :class:`~repro_torch.core.engine.Engine`)."""

    def __init__(
        self,
        n_devices: int,
        capacity: Union[int, Sequence[int]],
        policy: Union[str, Policy],
        strategy: Union[str, PlacementStrategy] = PlacementStrategy.LEAST_LOADED,
        switch_overhead: float = 0.0,
        memory: Optional[MemoryConfig] = None,
        deficit_quantum: Optional[int] = None,
        rebalancer: Optional[Rebalancer] = None,
        rebalance_interval: Union[float, EpochSchedule, None] = None,
        fault_injector: Optional[Any] = None,
        on_epoch: Optional[Callable[..., Any]] = None,
    ) -> None:
        self.placer = Placer(
            n_devices, capacity, strategy, deficit_quantum=deficit_quantum
        )
        self.policy = get_policy(policy)
        self.switch_overhead = switch_overhead
        self.memory = memory
        if on_epoch is not None and rebalance_interval is None:
            raise ValueError("on_epoch needs rebalance_interval to ever fire")
        self.on_epoch = on_epoch
        self._init_rebalance(rebalancer, rebalance_interval, fault_injector)
        self._submitted: List[JobSpec] = []
        self._plan: Optional[PlacementPlan] = None
        self._result: Optional[ClusterResult] = None

    @property
    def n_devices(self) -> int:
        return self.placer.n_devices

    # -- Engine protocol -----------------------------------------------

    def submit(self, job: JobSpec) -> None:
        if any(j.job_id == job.job_id for j in self._submitted):
            raise ValueError(
                f"duplicate job_id {job.job_id} ({job.name!r}): already submitted"
            )
        self._submitted.append(job)

    def result(self) -> Optional[ClusterResult]:
        return self._result

    def decision_log(self) -> List[tuple]:
        return self._plan.decision_log() if self._plan is not None else []

    def run(
        self,
        jobs: Optional[Sequence[JobSpec]] = None,
        until: Optional[float] = None,
        resume_done: Optional[Dict[int, int]] = None,
    ) -> ClusterResult:
        """``resume_done`` maps job_id -> iterations already committed in an
        earlier life of the job (crash recovery / a control-plane requeue):
        each listed job resumes from that boundary instead of iteration 0."""
        jobs = list(self._submitted if jobs is None else jobs)
        plan = self.placer.place(jobs)
        self._plan = plan
        # infeasible jobs still transit the biggest device's admission
        # control so they are rejected *in-engine* (uniform per-job stats,
        # N=1 decision-log parity with a bare Simulator)
        sink = max(
            range(self.n_devices), key=lambda i: self.placer.capacities[i]
        )
        sims = [
            Simulator(
                self.placer.capacities[i],
                self.policy,
                switch_overhead=self.switch_overhead,
                memory=self.memory,
            )
            for i in range(self.n_devices)
        ]
        for sim, dev_jobs in zip(sims, plan.device_jobs(jobs, route_rejected_to=sink)):
            sim.start(dev_jobs, done=resume_done)
        applied: List[Migration] = []
        if self.rebalance_schedule is None:
            for sim in sims:
                sim.advance(until)
        else:
            self._mig_seq = 0
            jobs_by_id = {j.job_id: j for j in jobs}
            self._rec_mark = [0] * len(sims)
            self._monitors = [StragglerMonitor() for _ in sims]
            # the event-core owns the epoch cadence: boundaries come from
            # the shared schedule (repeated addition, the same arithmetic
            # the concurrent fleet driver and the ctl daemon consume)
            sched = self.rebalance_schedule
            t = sched.next_boundary(0.0)
            while True:
                before = sum(len(s._records) for s in sims)
                horizon = t if until is None else min(t, until)
                for sim in sims:
                    sim.advance(horizon)
                if until is not None and horizon >= until:
                    break
                for sim in sims:
                    sim.drain_running()
                progress = sum(len(s._records) for s in sims) - before
                attempted = self._rebalance_sims(
                    sims, plan, horizon, jobs, jobs_by_id, applied
                )
                if self.on_epoch is not None:
                    # quiescent boundary: hand the control plane a snapshot
                    # plus an evict/cancel handle (a control-plane daemon
                    # persists progress + decision-log suffixes here, which
                    # is what makes a SIGKILL between epochs recoverable)
                    snap = EpochSnapshot(
                        time=horizon,
                        progress={
                            jid: st.iterations_done
                            for sim in sims
                            for jid, st in sim._stats.items()
                        },
                        states={
                            jid: s
                            for sim in sims
                            for jid, s in sim._state.items()
                        },
                        placement_log=plan.decision_log(),
                        device_logs=[sim.memory.decision_log() for sim in sims],
                        rejected=frozenset(
                            jid
                            for sim in sims
                            for jid, st in sim._stats.items()
                            if st.rejected
                        ),
                    )
                    self.on_epoch(snap, EpochControl(sims, plan, horizon))
                # quiescence != completion: after a drain nothing is queued
                # in the heaps, but READY jobs will re-schedule on the next
                # advance — keep going while any epoch makes progress, any
                # events remain, or a migration just changed the fleet
                if (
                    not attempted
                    and progress == 0
                    and not any(s.pending_events for s in sims)
                ):
                    break
                t = sched.next_boundary(t)
        self._result = ClusterResult(
            [sim.result() for sim in sims],
            plan,
            jobs={j.job_id: j for j in jobs},
            migrations=applied,
        )
        return self._result

    # -- rebalance epoch internals ---------------------------------------

    def _telemetry(
        self,
        dev_id: int,
        records: Sequence[IterationRecord],
        jobs_by_id: Dict[int, JobSpec],
    ) -> Tuple[float, float]:
        """Measured/declared dilation + strongest straggler flag since the
        last boundary — the JobStats/StragglerMonitor feedback the drift
        pass runs on. Durations are normalized by the job's declared
        iter_time before feeding the monitor so heterogeneous jobs share
        one distribution."""
        new = records[self._rec_mark[dev_id] :]
        self._rec_mark[dev_id] = len(records)
        mon = self._monitors[dev_id]
        n_flagged = len(mon.flagged)
        measured = declared = 0.0
        for r in new:
            spec = jobs_by_id.get(r.job_id)
            if spec is None or spec.iter_time <= 0:
                continue
            measured += r.duration
            declared += spec.iter_time
            mon.observe(r.index, r.duration / spec.iter_time)
        sigma = max((f.sigma for f in mon.flagged[n_flagged:]), default=0.0)
        return (measured / declared if declared > 0 else 1.0), sigma

    def _rebalance_sims(
        self,
        sims: List[Simulator],
        plan: PlacementPlan,
        t: float,
        jobs: Sequence[JobSpec],
        jobs_by_id: Dict[int, JobSpec],
        applied: List[Migration],
    ) -> int:
        views = []
        for dev_id, sim in enumerate(sims):
            jvs = []
            for jid, state in sim._state.items():
                if state in _TERMINAL or not sim.has_arrived(jid):
                    continue
                st = sim._stats[jid]
                jvs.append(
                    JobView(
                        spec=sim._jobs[jid],
                        done=st.iterations_done,
                        migrations=st.migrations,
                        movable=state is not JobState.RUNNING,
                    )
                )
            jvs.sort(key=lambda v: v.spec.job_id)
            dilation, sigma = self._telemetry(dev_id, sim._records, jobs_by_id)
            views.append(
                DeviceView(
                    dev_id,
                    sim.registry.capacity,
                    sim.registry,
                    jobs=jvs,
                    dilation=dilation,
                    straggler_sigma=sigma,
                )
            )
        attempted = 0
        for m in self.rebalancer.decide(views):
            attempted += 1
            if self._apply_sim(m, sims, plan, t):
                applied.append(m)
        self._replace_pending(sims, plan, t, jobs)
        return attempted

    def _apply_sim(
        self, m: Migration, sims: List[Simulator], plan: PlacementPlan, t: float
    ) -> bool:
        src, dst = sims[m.src], sims[m.dst]
        job = src._jobs[m.job_id]
        st, carry = src.migrate_out(job)
        self._mig_seq += 1
        try:
            if self.fault_injector is not None:
                self.fault_injector.maybe_fail(self._mig_seq)
        except InjectedFailure:
            # conservation under failure: the job is never lost — it lands
            # back on its source, paying the round-trip transfer again
            src.migrate_in(job, st, now=t, extra_delay=carry)
            self._log_migration(plan, PlacementEventKind.MIGRATE_FAILED, t, m, m.src)
            return False
        st.migrations += 1
        dst.migrate_in(job, st, now=t, extra_delay=carry)
        plan.assignments[m.job_id] = m.dst
        self._log_migration(plan, PlacementEventKind.MIGRATE, t, m, m.dst)
        return True

    def _replace_pending(
        self,
        sims: List[Simulator],
        plan: PlacementPlan,
        t: float,
        jobs: Sequence[JobSpec],
    ) -> None:
        """Re-bind jobs that have not *arrived* yet against the
        post-migration fleet, per the placer's strategy over live
        registries. Placement is a-priori; without this amendment a device
        consolidation could never shrink ``devices_used`` (the future
        arrival would re-open the just-emptied device)."""
        for job in jobs:
            jid = job.job_id
            cur = plan.assignments.get(jid)
            if cur is None or jid in plan.rejected:
                continue
            sim = sims[cur]
            if jid not in sim._jobs or sim.has_arrived(jid) or job.arrival_time <= t:
                continue
            best = self._choose_pending(sims, job)
            if best is None or best == cur:
                continue
            sim.remove_pending(job)
            sims[best].add_pending(job)
            plan.assignments[jid] = best
            plan.events.append(
                PlacementEvent(
                    PlacementEventKind.REPLACE, t, plan.order.get(jid, -1),
                    job.name, best, src_device_id=cur,
                )
            )

    def _choose_pending(self, sims: List[Simulator], job: JobSpec) -> Optional[int]:
        drain = self.rebalancer.drain if self.rebalancer is not None else frozenset()

        def free(sim: Simulator) -> int:
            reg = sim.registry
            return reg.capacity - reg.persistent_used - reg.lane_total

        def load(i: int) -> float:
            sim = sims[i]
            total = 0.0
            for jid, state in sim._state.items():
                if state in _TERMINAL:
                    continue
                spec = sim._jobs[jid]
                done = sim._stats[jid].iterations_done
                total += max(0, spec.n_iters - done) * spec.iter_time
            return total

        fits = [
            i
            for i, sim in enumerate(sims)
            if i not in drain
            and job.profile.total <= sim.registry.capacity
            and sim.memory._bytes_needed(job) == 0
        ]
        if not fits:
            return None
        strategy = self.placer.strategy
        if strategy is PlacementStrategy.LEAST_LOADED:
            key = lambda i: (load(i), i)
        elif strategy is PlacementStrategy.BEST_FIT:
            key = lambda i: (free(sims[i]), i)
        else:  # CONSOLIDATE: occupied and fullest first; open devices last
            key = lambda i: (not bool(sims[i].registry.assignment), free(sims[i]), i)
        return min(fits, key=key)


@dataclass
class ClusterReport(ResultSurface):
    """Live-side aggregation: per-device :class:`ExecutorReport`s plus the
    shared placement plan, with the same unified accessor surface as
    :class:`ClusterResult`."""

    device_reports: List[ExecutorReport]
    plan: PlacementPlan
    migrations: List[Migration] = field(default_factory=list)

    @property
    def stats(self) -> Dict[int, JobStats]:
        out: Dict[int, JobStats] = {}
        for rep in self.device_reports:
            out.update(rep.stats)
        return out

    @property
    def records(self) -> List[IterationRecord]:
        return [r for rep in self.device_reports for r in rep.records]

    @property
    def makespan(self) -> float:
        return max((rep.makespan for rep in self.device_reports), default=0.0)

    @property
    def devices_used(self) -> int:
        return sum(1 for rep in self.device_reports if rep.records)

    @property
    def per_device_utilization(self) -> List[float]:
        span = self.makespan
        if span <= 0.0:
            return [0.0 for _ in self.device_reports]
        return [busy_seconds(rep.records) / span for rep in self.device_reports]

    @property
    def utilization(self) -> float:
        per = self.per_device_utilization
        return sum(per) / len(per) if per else 0.0

    @property
    def failures(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        for rep in self.device_reports:
            out.update(rep.failures)
        return out

    @property
    def decision_log(self) -> DecisionLog:
        return DecisionLog(self.plan.decision_log())

    def decision_logs(self) -> List[List[tuple]]:
        return [rep.decision_log for rep in self.device_reports]

    def placement_log(self) -> List[tuple]:
        return self.plan.decision_log()

    def migration_log(self) -> List[tuple]:
        return self.plan.migration_log()


class ClusterExecutor(_RebalanceMixin):
    """The live fleet: N SalusExecutors driven per-device by the same
    placement decisions the simulation cluster uses. Sessions are
    collected via :meth:`submit`; :meth:`run` places their JobSpecs with
    the shared :class:`Placer`, hands each session to its device's
    executor, and drives the devices with a thread-per-device
    :class:`~repro_torch.core.fleet.FleetDriver`: per-device workers execute
    concurrently and synchronize at placement/rebalance epoch boundaries
    (the epoch-barrier rule — see CONTRIBUTING). Between barriers a worker
    touches only its own executor, so under nominal accounting each
    device's decision sequence is bitwise-identical to the old sequential
    device-at-a-time loop (``concurrency="sequential"`` keeps that loop;
    the self-differential test asserts byte-identical logs). With
    ``rebalance_interval`` set, migrations really move session state
    across the host link at the barrier (pinned host copies on the
    source, a copy to the destination executor's device on the other
    side). ``SalusExecutor.migrate_in``'s ``put_fn`` is where a
    mesh-aware restore, re-sharding onto another device layout, plugs in.

    There is no ``bind_jax_devices``: ``device`` names the executors'
    devices. ``"cuda"`` (the default, through
    :func:`repro_torch.device.device`) binds executor *i* to
    ``cuda:{i % torch.cuda.device_count()}``, so on one card every
    executor shares it and a migration is a real page-out to pinned host
    memory and a page-in; ``"cpu"`` puts every executor on the CPU (the
    tests). Without CUDA, anything but ``"cpu"`` raises."""

    def __init__(
        self,
        n_devices: int,
        capacity: Union[int, Sequence[int]],
        policy: Union[str, Policy],
        strategy: Union[str, PlacementStrategy] = PlacementStrategy.LEAST_LOADED,
        memory: Optional[MemoryConfig] = None,
        accounting: str = "wall",
        deficit_quantum: Optional[int] = None,
        rebalancer: Optional[Rebalancer] = None,
        rebalance_interval: Union[float, EpochSchedule, None] = None,
        fault_injector: Optional[Any] = None,
        concurrency: str = "threads",
        device: Union[str, torch.device, None] = None,
    ) -> None:
        if concurrency not in ("threads", "sequential"):
            raise ValueError(
                f"concurrency must be threads|sequential, got {concurrency!r}"
            )
        self.concurrency = concurrency
        self.placer = Placer(
            n_devices, capacity, strategy, deficit_quantum=deficit_quantum
        )
        # the live fleet's torch imports stay here: the simulated Cluster,
        # and the control plane over it, import without torch
        import torch

        from repro_torch.core.executor import SalusExecutor
        from repro_torch.device import device as device_of

        policy = get_policy(policy)
        dev = device_of(device)
        devices = [dev] * n_devices
        if dev.type == "cuda":
            n_cards = torch.cuda.device_count()
            devices = [torch.device("cuda", i % n_cards) for i in range(n_devices)]
        self.executors = [
            SalusExecutor(
                self.placer.capacities[i],
                policy,
                memory=memory,
                accounting=accounting,
                device=devices[i],
            )
            for i in range(n_devices)
        ]
        self._init_rebalance(rebalancer, rebalance_interval, fault_injector)
        self._sessions: List = []
        self._plan: Optional[PlacementPlan] = None
        self._report: Optional[ClusterReport] = None

    @property
    def n_devices(self) -> int:
        return self.placer.n_devices

    # -- Engine protocol -----------------------------------------------

    def submit(self, session: Any) -> None:
        if any(s.job.job_id == session.job.job_id for s in self._sessions):
            raise ValueError(
                f"duplicate job_id {session.job.job_id} "
                f"({session.job.name!r}): already submitted"
            )
        self._sessions.append(session)

    def result(self) -> Optional[ClusterReport]:
        return self._report

    def decision_log(self) -> List[tuple]:
        return self._plan.decision_log() if self._plan is not None else []

    def run(self, max_wall: Optional[float] = None) -> ClusterReport:
        """``max_wall`` is a *fleet-wide* wall budget measured from run()
        entry: under the default thread-per-device driver, devices run
        concurrently and each worker checks the same fleet clock; under
        ``concurrency="sequential"`` each device gets whatever remains."""
        plan = self.placer.place([s.job for s in self._sessions])
        self._plan = plan
        sink = max(
            range(self.n_devices), key=lambda i: self.placer.capacities[i]
        )
        for sess in self._sessions:
            dev = plan.assignments.get(sess.job.job_id)
            if dev is None and sess.job.job_id in plan.rejected:
                dev = sink  # rejected in-engine, mirroring Cluster.run
            if dev is not None:
                self.executors[dev].submit(sess)
        t0 = time.perf_counter()

        def remaining() -> Optional[float]:
            if max_wall is None:
                return None
            return max(0.0, max_wall - (time.perf_counter() - t0))

        applied: List[Migration] = []
        driver: Optional[FleetDriver] = None
        if self.concurrency == "threads":
            driver = FleetDriver(self.n_devices)
        try:
            if self.rebalance_schedule is not None:
                self._mig_seq = 0
                sched = self.rebalance_schedule
                t = sched.next_boundary(0.0)
                while True:
                    if driver is not None:
                        # concurrent epoch: every worker drives its own
                        # device to the shared horizon; the barrier inside
                        # map_epoch IS the epoch boundary — only after it
                        # may this (driver) thread touch the executors
                        # (epoch-barrier rule, see fleet.py / CONTRIBUTING)
                        counts = driver.map_epoch(
                            [
                                (
                                    lambda ex=ex, horizon=t: ex.run_epoch(
                                        horizon, max_wall=remaining()
                                    )
                                )
                                for ex in self.executors
                            ]
                        )
                        progress = sum(counts)
                    else:
                        progress = 0
                        for ex in self.executors:
                            progress += ex.run_epoch(t, max_wall=remaining())
                    attempted = self._rebalance_executors(plan, t, applied)
                    if not attempted and (
                        all(ex.done() for ex in self.executors) or progress == 0
                    ):
                        # quiescent fleet: either finished, or stalled work
                        # the final full drive below will surface (deadlock
                        # guard)
                        break
                    if max_wall is not None and time.perf_counter() - t0 > max_wall:
                        break
                    t = sched.next_boundary(t)
            if driver is not None:
                reports = driver.map_epoch(
                    [
                        (lambda ex=ex: ex.run(max_wall=remaining()))
                        for ex in self.executors
                    ]
                )
            else:
                reports = [ex.run(max_wall=remaining()) for ex in self.executors]
        finally:
            if driver is not None:
                driver.close()
        self._report = ClusterReport(reports, plan, migrations=applied)
        return self._report

    # -- rebalance epoch internals ---------------------------------------

    def _rebalance_executors(
        self, plan: PlacementPlan, t: float, applied: List[Migration]
    ) -> int:
        views = []
        for dev_id, ex in enumerate(self.executors):
            jvs = []
            for jid, state in ex.state.items():
                if state in _TERMINAL:
                    continue
                st = ex.stats[jid]
                jvs.append(
                    JobView(
                        spec=ex.sessions[jid].job,
                        done=st.iterations_done,
                        migrations=st.migrations,
                        movable=state is not JobState.RUNNING,
                    )
                )
            jvs.sort(key=lambda v: v.spec.job_id)
            views.append(
                DeviceView(dev_id, ex.registry.capacity, ex.registry, jobs=jvs)
            )
        attempted = 0
        for m in self.rebalancer.decide(views):
            attempted += 1
            src, dst = self.executors[m.src], self.executors[m.dst]
            sess, st, carry = src.migrate_out(m.job_id)
            self._mig_seq += 1
            try:
                if self.fault_injector is not None:
                    self.fault_injector.maybe_fail(self._mig_seq)
            except InjectedFailure:
                src.migrate_in(sess, st, extra_delay=carry)
                self._log_migration(
                    plan, PlacementEventKind.MIGRATE_FAILED, t, m, m.src
                )
                continue
            st.migrations += 1
            dst.migrate_in(sess, st, extra_delay=carry)
            plan.assignments[m.job_id] = m.dst
            self._log_migration(plan, PlacementEventKind.MIGRATE, t, m, m.dst)
            applied.append(m)
        return attempted
