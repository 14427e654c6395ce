"""Fleet placement layer: which device should host this job? The port's
copy of the JAX package's ``core/placement.py``, on the port's own lanes,
memory and types.

The cluster-level analogue of FINDLANE (paper §5.1's evaluation regime: a
fleet scheduler places jobs onto GPUs, Salus time-shares each GPU). Every
device runs its own :class:`LaneRegistry`/:class:`MemoryManager`/policy;
the placer decides, at submission time, which device a job joins, and
parks jobs no device can currently hold in a *deficit-ordered* pending
queue retried as modeled capacity frees — mirroring the single-device
second-chance machinery, so large jobs cannot be starved by a stream of
small arrivals at the cluster level either.

The placer is deliberately engine-agnostic: it reasons over
:class:`JobSpec`s with a per-device *shadow* :class:`LaneRegistry`
(byte-exact admission via ``MemoryManager._bytes_needed``) plus a
work-conserving load model (outstanding seconds of placed work), so the
same :class:`PlacementPlan` can drive N discrete-event Simulators or N
live SalusExecutors. Placement decides *where* a job runs; the chosen
device's own admission control still decides *when* (a bound job keeps
its original arrival time and may transit the device's second-chance
queue) — which is exactly what makes an N=1 cluster bitwise-identical to
a bare single-device engine.

Strategies:

* ``LEAST_LOADED`` — fewest outstanding seconds of placed work (classic
  least-work-left; spreads load, minimizes queueing).
* ``BEST_FIT``     — tightest byte fit: the admitting device with the
  least free persistent+ephemeral bytes (keeps big contiguous holes for
  future large jobs).
* ``CONSOLIDATE``  — pack onto the fewest devices (occupied, fullest
  first), keeping whole GPUs free — the Fig. 12 packing regime.

Two distinct passes share this module:

* **Arrival placement** (:class:`Placer`) — a-priori: each job is bound
  to a device when it is submitted, against a *modeled* fleet (shadow
  registries + work-conserving load). The binding is what the engines
  then replay, which is what makes an N=1 cluster bitwise-identical to a
  bare single-device run.
* **Rebalance passes** (:class:`Rebalancer`) — a-posteriori: at
  configurable iteration-boundary epochs the fleet driver snapshots the
  *live* devices into engine-agnostic :class:`DeviceView`s and asks the
  rebalancer for :class:`Migration`s — consolidating a fragmented fleet
  onto fewer devices, draining a device for maintenance, or evening out
  load when measured telemetry (:class:`DeviceView.dilation`, straggler
  sigma) drifts from the declared-trace model. Decisions are made
  against *cloned* registries (``LaneRegistry.clone``), never the live
  ones, so a rejected tentative pack leaves no trace; applying the
  migrations (``Simulator``/``SalusExecutor`` ``migrate_out`` →
  ``migrate_in``) is the cluster driver's job.
"""
from __future__ import annotations

import enum
import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core.lanes import LaneRegistry
from repro_torch.core.memory import MemoryManager
from repro_torch.core.types import JobSpec


class PlacementStrategy(enum.Enum):
    LEAST_LOADED = "least_loaded"
    BEST_FIT = "best_fit"
    CONSOLIDATE = "consolidate"


def get_strategy(name: Union[str, PlacementStrategy]) -> PlacementStrategy:
    """Resolve a strategy from a case-insensitive name or pass an enum
    member through unchanged — the one blessed entry point, mirrored by
    ``scheduler.get_policy``."""
    if isinstance(name, PlacementStrategy):
        return name
    if isinstance(name, str):
        try:
            return PlacementStrategy(name.lower())
        except ValueError:
            known = sorted(s.value for s in PlacementStrategy)
            raise KeyError(f"unknown placement strategy {name!r}; known: {known}")
    raise TypeError(
        f"strategy must be a name or PlacementStrategy, got {type(name).__name__}"
    )


class PlacementEventKind(enum.Enum):
    PLACE = "place"  # bound to a device at arrival
    QUEUE = "queue"  # no device admits now; parked in the cluster queue
    SECOND_CHANCE = "second_chance"  # bound later, from the pending queue
    REJECT = "reject"  # can never fit on any device (P + E > max C)
    MIGRATE = "migrate"  # live job moved src -> dst at an epoch boundary
    MIGRATE_FAILED = "migrate_failed"  # mid-migration failure; rolled back
    REPLACE = "replace"  # not-yet-arrived job re-bound at a boundary
    EVICT = "evict"  # control plane pulled the job off the fleet (progress kept)
    CANCEL = "cancel"  # control plane terminally cancelled the job in place


@dataclass(frozen=True)
class PlacementEvent:
    """One entry of the placement decision log. ``ordinal`` is the job's
    submission index, so traces with duplicate names cannot alias."""

    kind: PlacementEventKind
    time: float
    ordinal: int
    name: str
    device_id: Optional[int]  # None for QUEUE / REJECT; dst for MIGRATE*
    src_device_id: Optional[int] = None  # MIGRATE* / REPLACE source


@dataclass
class PlacementPlan:
    """Output of :meth:`Placer.place`: every submitted job is placed on
    exactly one device or rejected, with the full decision log."""

    n_devices: int
    assignments: Dict[int, int]  # job_id -> device_id
    rejected: set
    events: List[PlacementEvent] = field(default_factory=list)
    order: Dict[int, int] = field(default_factory=dict)  # job_id -> ordinal

    def device_jobs(
        self,
        jobs: Sequence[JobSpec],
        route_rejected_to: Optional[int] = None,
    ) -> List[List[JobSpec]]:
        """Per-device job lists in original submission order — device
        engines must see arrivals in trace order, not placement order, for
        bitwise reproducibility against a single-device run.

        ``route_rejected_to`` submits cluster-rejected jobs to that device
        anyway: its own admission control rejects them identically (their
        P + E exceeds every capacity), which keeps per-job stats and the
        device decision log in one-to-one correspondence with a bare
        single-device run of the same trace."""
        out: List[List[JobSpec]] = [[] for _ in range(self.n_devices)]
        for job in jobs:
            dev = self.assignments.get(job.job_id)
            if dev is None and job.job_id in self.rejected:
                dev = route_rejected_to
            if dev is not None:
                out[dev].append(job)
        return out

    def decision_log(self) -> List[tuple]:
        """(kind, submission-ordinal, name, device_id) projection, the
        time-free form compared across engines."""
        return [(e.kind.value, e.ordinal, e.name, e.device_id) for e in self.events]

    def migration_log(self) -> List[tuple]:
        """(kind, submission-ordinal, name, src_device, dst_device)
        projection of the boundary amendments (MIGRATE / MIGRATE_FAILED /
        REPLACE) — the time-free form the migration differential suite
        compares across engines."""
        kinds = (
            PlacementEventKind.MIGRATE,
            PlacementEventKind.MIGRATE_FAILED,
            PlacementEventKind.REPLACE,
        )
        return [
            (e.kind.value, e.ordinal, e.name, e.src_device_id, e.device_id)
            for e in self.events
            if e.kind in kinds
        ]


class _DeviceModel:
    """Shadow admission/load model of one device — no simulation, just the
    byte-exact lane safety condition plus a work-conserving queue model."""

    def __init__(self, device_id: int, capacity: int) -> None:
        self.device_id = device_id
        self.capacity = int(capacity)
        self.registry = LaneRegistry(self.capacity)
        # byte reasoning only: reuses MemoryManager._bytes_needed verbatim
        self._mm = MemoryManager(self.registry)
        self.busy_until = 0.0  # work-conserving: placed seconds drain FIFO

    def admits(self, job: JobSpec) -> bool:
        """Would some FINDLANE strategy admit ``job`` right now, given the
        jobs modeled resident?"""
        if job.profile.total > self.capacity:
            return False
        return self._mm._bytes_needed(job) == 0

    def place(self, job: JobSpec, now: float) -> float:
        """Bind ``job``; returns its modeled retirement time."""
        lane = self.registry.job_arrive(job)
        assert lane is not None, "place() without a passing admits() check"
        self.busy_until = max(self.busy_until, now) + job.total_work
        return self.busy_until

    def retire(self, job: JobSpec) -> None:
        self.registry.job_finish(job)

    def outstanding(self, now: float) -> float:
        return max(0.0, self.busy_until - now)

    @property
    def free_bytes(self) -> int:
        return (
            self.capacity
            - self.registry.persistent_used
            - self.registry.lane_total
        )

    @property
    def occupied(self) -> bool:
        return bool(self.registry.assignment)


class _LeastLoadedIndex:
    """O(log n) candidate selection for ``LEAST_LOADED``, equivalent to
    ``min(fits, key=(outstanding(now), device_id))`` over the admitting
    devices — the property the differential suite pins.

    Two lazy heaps partition the fleet. Every device has exactly one
    *valid* entry: idle devices (``busy_until <= now``) live in an
    id-ordered heap, busy ones in a ``(busy_until, device_id)`` heap.
    ``busy_until`` only ever grows (``place`` is work-conserving), so a
    popped busy entry is valid iff it still matches the device — stale
    entries are dropped and the newer one remains behind them. Ordering
    matches the scan's key exactly: idle devices all tie at outstanding
    0 and fall back to device_id; for busy devices ``outstanding =
    busy_until - now`` is strictly monotone in ``busy_until`` at a fixed
    ``now``, so ``(busy_until, id)`` heap order *is* ``(outstanding,
    id)`` order. Devices that fail ``admits`` are set aside and
    re-pushed so they stay candidates for later jobs."""

    def __init__(self, devices: List[_DeviceModel]) -> None:
        self._devices = devices
        self._idle: List[int] = list(range(len(devices)))  # already heap-ordered
        self._busy: List[tuple] = []  # (busy_until, device_id), lazily stale

    def choose(self, job: JobSpec, now: float) -> Optional[_DeviceModel]:
        devices, idle, busy = self._devices, self._idle, self._busy
        while busy and busy[0][0] <= now:
            bu, d = heapq.heappop(busy)
            if bu == devices[d].busy_until:
                heapq.heappush(idle, d)
        skipped_idle: List[int] = []
        chosen: Optional[_DeviceModel] = None
        while idle:
            dev = devices[heapq.heappop(idle)]
            if dev.busy_until > now:
                continue  # stale: placed on since it went idle; tracked in busy
            if dev.admits(job):
                chosen = dev
                break
            skipped_idle.append(dev.device_id)
        for d in skipped_idle:
            heapq.heappush(idle, d)
        if chosen is not None:
            return chosen
        skipped_busy: List[tuple] = []
        while busy:
            bu, d = heapq.heappop(busy)
            dev = devices[d]
            if bu != dev.busy_until:
                continue  # stale
            if dev.admits(job):
                chosen = dev
                break
            skipped_busy.append((bu, d))
        for entry in skipped_busy:
            heapq.heappush(busy, entry)
        return chosen

    def placed(self, dev: _DeviceModel) -> None:
        """Record a binding: the device's valid entry moves to the busy
        heap (``place`` guarantees ``busy_until > now`` afterwards). Its
        old entry — consumed by :meth:`choose` or left stale — is
        dropped lazily."""
        heapq.heappush(self._busy, (dev.busy_until, dev.device_id))


class Placer:
    """Assign every job in a trace to a device (or reject it), honoring
    the per-device lane safety condition at every binding."""

    def __init__(
        self,
        n_devices: int,
        capacity: Union[int, Sequence[int]],
        strategy: Union[str, PlacementStrategy] = PlacementStrategy.LEAST_LOADED,
        deficit_quantum: Optional[int] = None,
    ) -> None:
        if n_devices < 1:
            raise ValueError(f"n_devices must be >= 1, got {n_devices}")
        if isinstance(capacity, (int, float)):
            capacities = [int(capacity)] * n_devices
        else:
            capacities = [int(c) for c in capacity]
            if len(capacities) != n_devices:
                raise ValueError(
                    f"{len(capacities)} capacities for n_devices={n_devices}"
                )
        self.n_devices = n_devices
        self.capacities = capacities
        self.strategy = get_strategy(strategy)
        self.deficit_quantum = deficit_quantum

    # ------------------------------------------------------------------

    def _choose(
        self, devices: List[_DeviceModel], job: JobSpec, now: float
    ) -> Optional[_DeviceModel]:
        fits = [d for d in devices if d.admits(job)]
        if not fits:
            return None
        if self.strategy is PlacementStrategy.LEAST_LOADED:
            key = lambda d: (d.outstanding(now), d.device_id)
        elif self.strategy is PlacementStrategy.BEST_FIT:
            key = lambda d: (d.free_bytes, d.device_id)
        else:  # CONSOLIDATE: occupied and fullest first; open devices last
            key = lambda d: (not d.occupied, d.free_bytes, d.device_id)
        return min(fits, key=key)

    def place(self, jobs: Sequence[JobSpec]) -> PlacementPlan:
        devices = [
            _DeviceModel(i, cap) for i, cap in enumerate(self.capacities)
        ]
        order = {j.job_id: i for i, j in enumerate(jobs)}
        plan = PlacementPlan(
            self.n_devices, assignments={}, rejected=set(), order=order
        )
        pending: List[JobSpec] = []
        deficit: Dict[int, int] = {}
        seq = itertools.count()
        retire_heap: List[tuple] = []  # (est_finish, seq, device_id, job)
        max_cap = max(self.capacities) if self.capacities else 0
        # LEAST_LOADED dominates the diurnal-sweep profile: the linear
        # admits() scan per binding is O(jobs x devices). The lazy-heap
        # index gives the identical choice (see _LeastLoadedIndex) in
        # O(log devices) amortized; the byte-keyed strategies keep the
        # scan — their keys change on every retire, not just on place.
        index = (
            _LeastLoadedIndex(devices)
            if self.strategy is PlacementStrategy.LEAST_LOADED
            else None
        )

        def quantum(job: JobSpec) -> int:
            q = self.deficit_quantum
            return q if q is not None else job.profile.total

        def bind(job: JobSpec, now: float, kind: PlacementEventKind) -> bool:
            if index is not None:
                dev = index.choose(job, now)
            else:
                dev = self._choose(devices, job, now)
            if dev is None:
                return False
            est = dev.place(job, now)
            if index is not None:
                index.placed(dev)
            heapq.heappush(retire_heap, (est, next(seq), dev.device_id, job))
            plan.assignments[job.job_id] = dev.device_id
            plan.events.append(
                PlacementEvent(kind, now, order[job.job_id], job.name, dev.device_id)
            )
            deficit.pop(job.job_id, None)
            return True

        def retry(now: float) -> None:
            # the cluster-level second chance: accrue deficit for every job
            # denied placement this round, retry highest-deficit-first
            # (FIFO within ties), exactly like MemoryManager's boundary tick
            if not pending:
                return
            for j in pending:
                deficit[j.job_id] = deficit.get(j.job_id, 0) + quantum(j)
            pending.sort(key=lambda j: (-deficit[j.job_id], order[j.job_id]))
            for j in list(pending):
                if bind(j, now, PlacementEventKind.SECOND_CHANCE):
                    pending.remove(j)

        def drain_until(now: float) -> None:
            while retire_heap and retire_heap[0][0] <= now:
                est, _, dev_id, job = heapq.heappop(retire_heap)
                devices[dev_id].retire(job)
                retry(est)

        arrivals = sorted(jobs, key=lambda j: (j.arrival_time, order[j.job_id]))
        for job in arrivals:
            now = job.arrival_time
            drain_until(now)
            if job.profile.total > max_cap:
                plan.rejected.add(job.job_id)
                plan.events.append(
                    PlacementEvent(
                        PlacementEventKind.REJECT, now, order[job.job_id], job.name, None
                    )
                )
                continue
            if not bind(job, now, PlacementEventKind.PLACE):
                pending.append(job)
                deficit.setdefault(job.job_id, 0)
                plan.events.append(
                    PlacementEvent(
                        PlacementEventKind.QUEUE, now, order[job.job_id], job.name, None
                    )
                )
        # flush: keep retiring modeled work until the pending queue drains
        # (an empty device admits anything with P + E <= its capacity, so
        # every non-rejected job binds eventually)
        while pending and retire_heap:
            est, _, dev_id, job = heapq.heappop(retire_heap)
            devices[dev_id].retire(job)
            retry(est)
        if pending:
            names = [j.name for j in pending]
            raise RuntimeError(f"unplaceable jobs after full drain: {names}")
        return plan


# ----------------------------------------------------------------------
# Rebalance passes: migration decisions at quiescent epoch boundaries
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class Migration:
    """One decided move: ``job_id`` (engine-local) leaves ``src`` for
    ``dst``. ``reason`` records which pass produced it."""

    job_id: int
    name: str
    src: int
    dst: int
    reason: str  # "consolidate" | "drain" | "rebalance"


@dataclass
class JobView:
    """Engine-agnostic snapshot of one live (arrived, unfinished) job at a
    quiescent boundary. ``movable`` is False only for jobs the engine
    cannot release right now (never the case after a drain)."""

    spec: JobSpec
    done: int = 0
    migrations: int = 0
    movable: bool = True

    @property
    def remaining_iters(self) -> int:
        return max(0, self.spec.n_iters - self.done)

    @property
    def remaining_work(self) -> float:
        """Declared-trace seconds of work left (the load model both engines
        agree on byte-for-byte, unlike measured wall time)."""
        return self.remaining_iters * self.spec.iter_time


@dataclass
class DeviceView:
    """Engine-agnostic snapshot of one device at a quiescent boundary.
    ``registry`` is the device's *live* :class:`LaneRegistry` — the
    rebalancer only ever clones it. ``dilation`` is measured/declared
    iteration time since the last boundary (1.0 = running at the declared
    rate); ``straggler_sigma`` is the strongest StragglerMonitor flag in
    the same window (0.0 = none). Both feed the ``use_telemetry`` drift
    pass only — the default declared-load model ignores them, which is
    what keeps sim/executor rebalance decisions comparable."""

    device_id: int
    capacity: int
    registry: LaneRegistry
    jobs: List[JobView] = field(default_factory=list)
    dilation: float = 1.0
    straggler_sigma: float = 0.0


class _Shadow:
    """A cloned registry plus the byte-exact admission check, the only
    state the rebalancer mutates while reasoning."""

    def __init__(self, view: DeviceView, registry: Optional[LaneRegistry] = None) -> None:
        self.device_id = view.device_id
        self._view = view
        self.registry = registry if registry is not None else view.registry.clone()
        self._mm = MemoryManager(self.registry)

    def clone(self) -> "_Shadow":
        return _Shadow(self._view, self.registry.clone())

    def live_ids(self) -> List[int]:
        ids = set(self.registry.assignment)
        ids.update(j.job_id for j in self.registry.queue)
        return sorted(ids)

    def admits(self, job: JobSpec) -> bool:
        return (
            job.profile.total <= self.registry.capacity
            and self._mm._bytes_needed(job) == 0
        )

    def add(self, job: JobSpec) -> None:
        self.registry.job_arrive(job)

    def remove(self, job: JobSpec) -> None:
        self.registry.job_depart(job)

    @property
    def occupied(self) -> bool:
        return bool(self.registry.assignment) or bool(self.registry.queue)

    @property
    def free_bytes(self) -> int:
        return (
            self.registry.capacity
            - self.registry.persistent_used
            - self.registry.lane_total
        )


class Rebalancer:
    """Decide cross-device migrations at a quiescent epoch boundary.

    Modes:

    * ``"consolidate"`` — empty the cheapest fully-movable device into the
      other occupied ones (fullest-first, all-or-nothing), shrinking the
      set of devices in use: defrag-by-migration, the boundary-time
      counterpart of the Fig. 12 packing regime.
    * ``"rebalance"``  — while the max/min device load gap exceeds
      ``imbalance_threshold`` × mean, move the job that best closes it.
      With ``use_telemetry`` the loads are dilated by measured drift
      (:class:`DeviceView.dilation`, rescaled to each candidate
      population's modeled contention pressure so stale samples cannot
      ping-pong a pass; straggler sigma breaks ties toward unloading
      flagged devices), otherwise pure declared-trace work.
    * ``"none"``       — no balancing; only the ``drain`` pass runs.

    ``drain`` devices are evacuated first (bypassing
    ``min_remaining_iters``/``max_migrations_per_job`` — maintenance wins)
    and excluded as destinations. All reasoning happens on cloned
    registries; ``decide`` returns the moves, it never touches an engine.
    """

    def __init__(
        self,
        mode: str = "consolidate",
        drain: Sequence[int] = (),
        imbalance_threshold: float = 0.25,
        min_remaining_iters: int = 2,
        max_migrations_per_job: int = 3,
        use_telemetry: bool = False,
    ) -> None:
        if mode not in ("consolidate", "rebalance", "none"):
            raise ValueError(
                f"mode must be consolidate|rebalance|none, got {mode!r}"
            )
        if imbalance_threshold < 0:
            raise ValueError("imbalance_threshold must be >= 0")
        self.mode = mode
        self.drain = frozenset(int(d) for d in drain)
        self.imbalance_threshold = imbalance_threshold
        self.min_remaining_iters = min_remaining_iters
        self.max_migrations_per_job = max_migrations_per_job
        self.use_telemetry = use_telemetry

    # ------------------------------------------------------------------

    def decide(self, views: Sequence[DeviceView]) -> List[Migration]:
        views = sorted(views, key=lambda v: v.device_id)
        jv_by_id = {jv.spec.job_id: jv for v in views for jv in v.jobs}
        shadows = {v.device_id: _Shadow(v) for v in views}
        migs: List[Migration] = []
        moved: set = set()  # one move per job per decide (no intra-round ping-pong)
        self._drain_pass(views, shadows, jv_by_id, migs, moved)
        if self.mode == "consolidate":
            self._consolidate(views, shadows, jv_by_id, migs, moved)
        elif self.mode == "rebalance":
            self._rebalance(views, shadows, jv_by_id, migs, moved)
        return migs

    # ------------------------------------------------------------------

    def _eligible(self, jv: Optional[JobView], moved: set, drain: bool = False) -> bool:
        if jv is None or not jv.movable or jv.spec.job_id in moved:
            return False
        if drain:
            return True
        if jv.migrations >= self.max_migrations_per_job:
            return False
        return jv.remaining_iters >= self.min_remaining_iters

    def _est_dilation(self, view: DeviceView, live: Sequence[JobView]) -> float:
        """Expected dilation of ``view``'s device if it held exactly the
        ``live`` jobs. Measured telemetry reflects the population present
        when it was sampled; applying it verbatim to a population a pass
        has already changed over-weights sources with stale contention
        (classic rebalance ping-pong). Scale by the modeled contention
        pressure ratio instead — ``max(1, sum(utilization))``, the packing
        model's dilation — so moving jobs off a device immediately lowers
        its expected load."""
        if not self.use_telemetry:
            return 1.0
        util_meas = max(1.0, sum(jv.spec.utilization for jv in view.jobs))
        util_now = max(1.0, sum(jv.spec.utilization for jv in live))
        meas = view.dilation if view.dilation > 0 else 1.0
        return meas * util_now / util_meas

    def _live(self, shadow: _Shadow, jv_by_id: Dict[int, JobView]) -> List[JobView]:
        return [jv_by_id[jid] for jid in shadow.live_ids() if jid in jv_by_id]

    def _load(self, shadow: _Shadow, jv_by_id: Dict[int, JobView]) -> float:
        live = self._live(shadow, jv_by_id)
        total = sum(jv.remaining_work for jv in live)
        return total * self._est_dilation(shadow._view, live)

    def _drain_pass(
        self,
        views: List[DeviceView],
        shadows: Dict[int, _Shadow],
        jv_by_id: Dict[int, JobView],
        migs: List[Migration],
        moved: set,
    ) -> None:
        if not self.drain:
            return
        dst_ids = [v.device_id for v in views if v.device_id not in self.drain]
        for v in views:
            if v.device_id not in self.drain:
                continue
            src = shadows[v.device_id]
            for jid in src.live_ids():
                jv = jv_by_id.get(jid)
                if not self._eligible(jv, moved, drain=True):
                    continue
                # consolidate-like destination order; empty devices allowed
                # (a drain must succeed even if it opens a fresh device)
                cands = sorted(
                    (shadows[d] for d in dst_ids),
                    key=lambda s: (not s.occupied, s.free_bytes, s.device_id),
                )
                for dst in cands:
                    if dst.admits(jv.spec):
                        src.remove(jv.spec)
                        dst.add(jv.spec)
                        moved.add(jid)
                        migs.append(
                            Migration(jid, jv.spec.name, src.device_id, dst.device_id, "drain")
                        )
                        break

    def _consolidate(
        self,
        views: List[DeviceView],
        shadows: Dict[int, _Shadow],
        jv_by_id: Dict[int, JobView],
        migs: List[Migration],
        moved: set,
    ) -> None:
        while True:
            occupied = [
                s
                for s in shadows.values()
                if s.occupied and s.device_id not in self.drain
            ]
            if len(occupied) < 2:
                return
            # cheapest source first: least remaining declared work
            srcs = sorted(
                occupied, key=lambda s: (self._load(s, jv_by_id), s.device_id)
            )
            committed = False
            for src in srcs:
                jvs = [jv_by_id.get(jid) for jid in src.live_ids()]
                if not jvs or any(not self._eligible(jv, moved) for jv in jvs):
                    continue  # cannot fully empty this device
                # all-or-nothing: pack into trial clones of the other
                # occupied devices, biggest job first, fullest device first
                trial = {s.device_id: s.clone() for s in occupied if s is not src}
                plan_moves = []
                ok = True
                for jv in sorted(
                    jvs, key=lambda j: (-j.spec.profile.total, j.spec.job_id)
                ):
                    for t in sorted(
                        trial.values(), key=lambda t: (t.free_bytes, t.device_id)
                    ):
                        if t.admits(jv.spec):
                            t.add(jv.spec)
                            plan_moves.append((jv, t.device_id))
                            break
                    else:
                        ok = False
                        break
                if not ok:
                    continue
                for jv, dst_id in plan_moves:
                    src.remove(jv.spec)
                    moved.add(jv.spec.job_id)
                    migs.append(
                        Migration(
                            jv.spec.job_id, jv.spec.name, src.device_id, dst_id, "consolidate"
                        )
                    )
                shadows.update(trial)
                committed = True
                break  # recompute the occupied set from scratch
            if not committed:
                return

    def _rebalance(
        self,
        views: List[DeviceView],
        shadows: Dict[int, _Shadow],
        jv_by_id: Dict[int, JobView],
        migs: List[Migration],
        moved: set,
    ) -> None:
        views_by_id = {v.device_id: v for v in views}
        pool = [s for s in shadows.values() if s.device_id not in self.drain]
        if len(pool) < 2:
            return
        for _ in range(64):  # bounded: each round moves exactly one job
            loads = {s.device_id: self._load(s, jv_by_id) for s in pool}
            mean = sum(loads.values()) / len(loads)
            hi = max(
                pool,
                key=lambda s: (
                    loads[s.device_id],
                    views_by_id[s.device_id].straggler_sigma,
                    -s.device_id,
                ),
            )
            lo = min(
                pool,
                key=lambda s: (
                    loads[s.device_id],
                    -views_by_id[s.device_id].straggler_sigma,
                    s.device_id,
                ),
            )
            gap = loads[hi.device_id] - loads[lo.device_id]
            if mean <= 0 or gap <= self.imbalance_threshold * mean:
                return
            hi_live = self._live(hi, jv_by_id)
            lo_live = self._live(lo, jv_by_id)
            hi_view = views_by_id[hi.device_id]
            lo_view = views_by_id[lo.device_id]
            moved_one = False
            for jid in sorted(
                hi.live_ids(),
                key=lambda j: (
                    -(jv_by_id[j].remaining_work if j in jv_by_id else 0.0),
                    j,
                ),
            ):
                jv = jv_by_id.get(jid)
                if not self._eligible(jv, moved):
                    continue
                w = jv.remaining_work
                if w <= 0:
                    continue
                # expected loads after the move, each side re-weighted by
                # its post-move population's estimated dilation
                hi_rest = [x for x in hi_live if x.spec.job_id != jid]
                new_hi = sum(x.remaining_work for x in hi_rest) * self._est_dilation(
                    hi_view, hi_rest
                )
                new_lo = (
                    sum(x.remaining_work for x in lo_live) + w
                ) * self._est_dilation(lo_view, lo_live + [jv])
                new_gap = abs(new_hi - new_lo)
                if new_gap >= gap:
                    continue  # would overshoot; try a smaller job
                if lo.admits(jv.spec):
                    hi.remove(jv.spec)
                    lo.add(jv.spec)
                    moved.add(jid)
                    migs.append(
                        Migration(jid, jv.spec.name, hi.device_id, lo.device_id, "rebalance")
                    )
                    moved_one = True
                    break
            if not moved_one:
                return
