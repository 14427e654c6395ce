"""Salus core for the PyTorch port: the live execution service on one
device. The decision modules (types, lanes, memory, scheduler) are copies
of the JAX package's, so the port's executor takes the decisions the JAX
simulator takes on the same trace.

Public surface:
  * :class:`SalusExecutor` + :class:`VirtualDevice` — live execution service
  * :class:`LaneRegistry` — GPU lanes, Algorithm 1, safety condition, defrag
  * :class:`MemoryManager` — admission, second chance, host paging
  * policies — FIFO / SRTF / PACK / FAIR / PRIORITY (``get_policy``)
"""
from repro_torch.core.adaptor import VirtualDevice
from repro_torch.core.engine import DecisionLog, ResultSurface, busy_seconds
from repro_torch.core.executor import ExecutorReport, SalusExecutor
from repro_torch.core.lanes import Lane, LaneRegistry, SafetyViolation
from repro_torch.core.memory import MemoryConfig, MemoryManager
from repro_torch.core.profiles import profile_step, tensor_bytes
from repro_torch.core.scheduler import FAIR, FIFO, PACK, PRIORITY, SRTF, Policy, get_policy
from repro_torch.core.session import Session
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

__all__ = [
    "ResultSurface",
    "DecisionLog",
    "busy_seconds",
    "SalusExecutor",
    "ExecutorReport",
    "VirtualDevice",
    "Session",
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
