"""Core Salus types: memory profiles, job specs, iteration records, events.

The paper's memory taxonomy (§3.2.1) maps 1:1:
  * model + framework-internal  -> MemoryProfile.persistent
  * ephemeral (per-iteration)   -> MemoryProfile.ephemeral
In the PyTorch port these are measured by running one step:
persistent = bytes of the state tensors, ephemeral = the allocator's peak
over the step above what was allocated before it (see profiles.profile_step).
"""
from __future__ import annotations

import enum
import itertools
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

MB = 1024 * 1024
GB = 1024 * MB


def percentile(values: List[float], q: float) -> Optional[float]:
    """True nearest-rank percentile (q in [0, 1]) of an unsorted sample;
    None on an empty sample. Shared by JobStats and the serving benchmarks
    so both report identical tail figures.

    Rank is ``ceil(q * n)`` (1-based; q = 0 means the minimum). The
    previous ``int(round(q * (n - 1)))`` form went through Python's
    banker's rounding, so exact-.5 ranks flipped direction with
    sample-size parity (p50 of 4 samples picked the upper median while
    p50 of 100 samples picked the lower one)."""
    if not values:
        return None
    if not (0.0 <= q <= 1.0):
        raise ValueError(f"q must be in [0, 1], got {q}")
    v = sorted(values)
    if q == 0.0:
        return v[0]
    return v[min(len(v) - 1, math.ceil(q * len(v)) - 1)]


@dataclass(frozen=True)
class MemoryProfile:
    """P_i and E_i of a job, in bytes."""

    persistent: int
    ephemeral: int

    @property
    def total(self) -> int:
        return self.persistent + self.ephemeral


@dataclass
class JobSpec:
    """One DL job submitted to Salus (a training run or an inference
    service). Iteration-granularity: the job is ``n_iters`` iterations of
    ``iter_time`` seconds each when running alone.

    Closed vs open loop: by default every iteration is always ready (a
    training run). When ``request_times`` is set the job is an *open-loop
    inference service*: iteration k is a request that only becomes runnable
    once ``request_times[k]`` has passed — requests queue, and the engines
    record per-request queueing+service latency into ``JobStats``.

    ``priority`` is the strict-priority class for the PRIORITY policy
    (higher wins). ``None`` defers to the kind default: inference is the
    latency-critical class (1), training best-effort (0), matching the
    paper's §5.3 co-location regime.
    """

    name: str
    profile: MemoryProfile
    n_iters: int
    iter_time: float  # seconds, solo
    utilization: float = 1.0  # fraction of device compute used when solo
    arrival_time: float = 0.0
    kind: str = "train"  # train | inference
    priority: Optional[int] = None  # strict-priority class; None -> kind default
    request_times: Optional[Tuple[float, ...]] = None  # open-loop arrivals
    # Optional live-execution payload (set by the adaptor):
    run_iteration: Optional[Callable[[int], Any]] = None
    meta: Dict[str, Any] = field(default_factory=dict)

    _ids = itertools.count()

    def __post_init__(self) -> None:
        self.job_id = next(JobSpec._ids)
        if not (0.0 < self.utilization <= 1.0):
            raise ValueError(f"utilization must be in (0, 1], got {self.utilization}")
        if self.request_times is not None:
            self.request_times = tuple(float(t) for t in self.request_times)
            if len(self.request_times) != self.n_iters:
                raise ValueError(
                    f"request_times has {len(self.request_times)} entries "
                    f"for n_iters={self.n_iters}"
                )
            if any(b < a for a, b in zip(self.request_times, self.request_times[1:])):
                raise ValueError("request_times must be non-decreasing")

    @property
    def effective_priority(self) -> int:
        """Strict-priority class: explicit ``priority`` wins, else the kind
        default (inference high, training low)."""
        if self.priority is not None:
            return self.priority
        return 1 if self.kind == "inference" else 0

    def next_request_time(self, done: int) -> Optional[float]:
        """Arrival time of request ``done`` (the next one to serve), or None
        for closed-loop jobs / exhausted request streams."""
        if self.request_times is None or done >= len(self.request_times):
            return None
        return self.request_times[done]

    def request_pending(self, done: int, now: float) -> bool:
        """Is iteration ``done`` runnable at ``now``? Closed-loop jobs are
        always ready; open-loop jobs only once the request has arrived.
        This single gate is shared by the simulator and the executor — the
        request-arrival machinery must not fork between engines."""
        if self.request_times is None:
            return True
        return done < len(self.request_times) and self.request_times[done] <= now

    def __hash__(self) -> int:
        # the id itself, not builtin hash(): anything feeding ordering or
        # seeding must be stable across processes (PYTHONHASHSEED) — RPL003
        return self.job_id

    def __eq__(self, other: object) -> bool:
        return isinstance(other, JobSpec) and other.job_id == self.job_id


class JobState(enum.Enum):
    QUEUED = "queued"  # waiting for a lane (memory admission)
    READY = "ready"  # has a lane, waiting for scheduler
    RUNNING = "running"  # executing an iteration
    PAUSED = "paused"  # preempted at an iteration boundary
    PAGED = "paged"  # admitted, but persistent region paged out to host
    FINISHED = "finished"
    FAILED = "failed"  # step_fn raised; terminal, lane freed
    CANCELLED = "cancelled"  # evicted by the control plane; terminal, lane freed


class MemoryEventKind(enum.Enum):
    """Admission-control / fungible-memory decisions (MemoryManager)."""

    ADMIT = "admit"  # got a lane at arrival
    QUEUE = "queue"  # denied at arrival, parked in the pending queue
    SECOND_CHANCE = "second_chance"  # re-admitted from the pending queue
    PAGE_OUT = "page_out"  # persistent region moved device -> host
    PAGE_IN = "page_in"  # persistent region moved host -> device
    REJECT = "reject"  # can never fit (P + E > C)
    LANE_MOVED = "lane_moved"  # auto-defrag relocated a lane (zero-copy)
    MIGRATE_OUT = "migrate_out"  # job departed this device for another
    MIGRATE_IN = "migrate_in"  # job arrived from another device


@dataclass
class MemoryEvent:
    """One entry of the memory manager's decision log. ``cost`` is the
    transfer time in seconds (modeled in the simulator, measured in the
    executor); decision comparisons must ignore ``time`` and ``cost``."""

    kind: MemoryEventKind
    time: float
    job_id: int
    job: Optional["JobSpec"] = None
    lane_id: Optional[int] = None
    nbytes: int = 0
    cost: float = 0.0
    # arrival ordinal within the owning MemoryManager, stamped at log time
    # so the decision log stays stable after per-job bookkeeping is dropped
    ordinal: Optional[int] = None

    @property
    def name(self) -> Optional[str]:
        return self.job.name if self.job is not None else None


@dataclass
class JobStats:
    arrival_time: float = 0.0
    admit_time: Optional[float] = None  # got a lane
    first_run_time: Optional[float] = None
    finish_time: Optional[float] = None
    iterations_done: int = 0
    service_time: float = 0.0  # accumulated wall-time of its iterations
    preemptions: int = 0
    # fungible-memory accounting (MemoryManager):
    page_outs: int = 0
    page_ins: int = 0
    transfer_time: float = 0.0  # seconds spent moving P across the host link
    second_chances: int = 0  # failed re-admission rounds while pending
    migrations: int = 0  # completed cross-device moves (rebalance passes)
    rejected: bool = False  # can never fit (P + E > C)
    failed: bool = False  # step_fn raised in the live executor
    last_run_end: Optional[float] = None  # end of the most recent iteration
    # open-loop serving accounting: one entry per completed request =
    # (completion - request arrival), i.e. queueing + service time
    request_latencies: List[float] = field(default_factory=list)

    @property
    def jct(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def queuing(self) -> Optional[float]:
        if self.first_run_time is None:
            return None
        return self.first_run_time - self.arrival_time

    # -- open-loop latency helpers (nearest-rank percentiles) -----------

    def latency_percentile(self, q: float) -> Optional[float]:
        return percentile(self.request_latencies, q)

    @property
    def p50_latency(self) -> Optional[float]:
        return self.latency_percentile(0.50)

    @property
    def p95_latency(self) -> Optional[float]:
        return self.latency_percentile(0.95)

    @property
    def p99_latency(self) -> Optional[float]:
        return self.latency_percentile(0.99)


@dataclass
class IterationRecord:
    job_id: int
    index: int
    start: float
    end: float
    lane_id: int

    @property
    def duration(self) -> float:
        return self.end - self.start
