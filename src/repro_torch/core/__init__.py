"""Salus core for the PyTorch port: the live execution service on one
device. The decision modules (types, lanes, memory, scheduler) are copies
of the JAX package's, so the port's executor takes the decisions the JAX
simulator takes on the same trace.

Public surface:
  * :class:`Engine` protocol + :class:`ResultSurface` accessors — the one
    API both backends speak (``submit``/``run``/``result``/``decision_log``)
  * :class:`SalusExecutor` + :class:`VirtualDevice` — live execution service
  * :class:`Simulator` — discrete-event trace evaluation, on the same
    decision modules as the executor; :class:`EventQueue` /
    :class:`EpochSchedule` — the event core it runs on
  * :class:`Cluster` / :class:`ClusterExecutor` — multi-GPU fleet behind
    placement strategies (``get_strategy``: least_loaded/best_fit/consolidate)
    with optional :class:`Rebalancer` migration passes at epoch boundaries,
    driven by :class:`FleetDriver`'s thread-per-device epochs
  * :class:`LaneRegistry` — GPU lanes, Algorithm 1, safety condition, defrag
  * :class:`MemoryManager` — admission, second chance, host paging
  * policies — FIFO / SRTF / PACK / FAIR / PRIORITY (``get_policy``)
  * profiles / tracegen — the paper's workload tables + trace and
    request-stream generation
"""
import importlib

from repro_torch.core.cluster import (
    Cluster,
    ClusterExecutor,
    ClusterReport,
    ClusterResult,
    EpochControl,
    EpochSnapshot,
)
from repro_torch.core.engine import (
    DecisionLog,
    Engine,
    ResultSurface,
    busy_seconds,
    decode_decision,
    decode_decision_log,
    encode_decision,
    encode_decision_log,
)
from repro_torch.core.events import EpochSchedule, EventQueue
from repro_torch.core.fleet import FleetDriver
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
    get_strategy,
)
from repro_torch.core.lanes import Lane, LaneRegistry, SafetyViolation
from repro_torch.core.memory import MemoryConfig, MemoryManager
from repro_torch.core.scheduler import FAIR, FIFO, PACK, PRIORITY, SRTF, Policy, get_policy
from repro_torch.core.simulator import SimResult, Simulator
from repro_torch.core.types import (
    GB,
    MB,
    JobSpec,
    JobState,
    JobStats,
    MemoryEvent,
    MemoryEventKind,
    MemoryProfile,
    percentile,
)

# The live engine's modules import torch; they load at a name's first use,
# so the simulated engines (and the control plane over them) import
# without torch.
_LIVE = {
    "VirtualDevice": "adaptor",
    "ExecutorReport": "executor",
    "SalusExecutor": "executor",
    "profile_model": "profiles",
    "profile_step": "profiles",
    "tensor_bytes": "profiles",
    "Session": "session",
}


def __getattr__(name: str):
    if name not in _LIVE:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{_LIVE[name]}"), name)


__all__ = [
    "Engine",
    "ResultSurface",
    "DecisionLog",
    "busy_seconds",
    "encode_decision",
    "decode_decision",
    "encode_decision_log",
    "decode_decision_log",
    "EventQueue",
    "EpochSchedule",
    "FleetDriver",
    "EpochSnapshot",
    "EpochControl",
    "Simulator",
    "SimResult",
    "SalusExecutor",
    "ExecutorReport",
    "VirtualDevice",
    "Cluster",
    "ClusterExecutor",
    "ClusterReport",
    "ClusterResult",
    "Placer",
    "PlacementEvent",
    "PlacementEventKind",
    "PlacementPlan",
    "PlacementStrategy",
    "get_strategy",
    "Rebalancer",
    "Migration",
    "DeviceView",
    "JobView",
    "Session",
    "profile_model",
    "profile_step",
    "tensor_bytes",
    "MemoryConfig",
    "MemoryManager",
    "MemoryEvent",
    "MemoryEventKind",
    "Lane",
    "LaneRegistry",
    "SafetyViolation",
    "FIFO",
    "SRTF",
    "PACK",
    "FAIR",
    "PRIORITY",
    "Policy",
    "get_policy",
    "JobSpec",
    "JobState",
    "JobStats",
    "MemoryProfile",
    "GB",
    "MB",
    "percentile",
]
