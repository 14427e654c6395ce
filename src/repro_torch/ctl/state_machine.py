"""Strict job-lifecycle state machine for the persistent control plane
(the port's copy of the JAX package's ``ctl/state_machine.py``, over the
port's :class:`~repro_torch.core.types.JobState`).

Every job the daemon owns moves through::

    SUBMITTED ──► ADMITTED ──► RUNNING ──► {PAUSED, PAGED, MIGRATING}
        ▲             │            │ ▲            │
        └── requeue ──┴────────────┘ └────────────┘
                      │
                      ▼
        {FINISHED, FAILED, CANCELLED}          (terminal, absorbing)

* ``SUBMITTED``  — durably recorded; not yet claimed by a fleet run.
* ``ADMITTED``   — claimed by a fleet run; transiting the engine's
  admission control (may be queued/paged there before first running).
* ``RUNNING``    — the engine is actively scheduling its iterations
  (engine-level READY/RUNNING/preempted-PAUSED all map here: at epoch
  granularity the job is being served).
* ``PAUSED``     — *user* pause: evicted from the fleet at a quiescent
  boundary with its progress kept; ``resume`` requeues it.
* ``PAGED``      — admitted but its persistent region lives on host
  (the engine's fungible-memory paging).
* ``MIGRATING``  — moved between devices at the last epoch boundary.
* ``FINISHED`` / ``FAILED`` / ``CANCELLED`` — terminal; nothing leaves.

The requeue edges (non-terminal, non-SUBMITTED -> SUBMITTED) are what
crash recovery uses: after a daemon restart every job a dead fleet run
owned is resubmitted from its last *committed* iteration boundary.

``validate_transition`` is enforced by the durable store on every state
write, so an illegal lifecycle hop can never be persisted — replaying the
``transitions`` table through this machine is the store's
crash-consistency check.
"""
from __future__ import annotations

import enum
from typing import Dict, FrozenSet

from repro_torch.core.types import JobState


class CtlState(enum.Enum):
    SUBMITTED = "submitted"
    ADMITTED = "admitted"
    RUNNING = "running"
    PAUSED = "paused"
    PAGED = "paged"
    MIGRATING = "migrating"
    FINISHED = "finished"
    FAILED = "failed"
    CANCELLED = "cancelled"


TERMINAL: FrozenSet[CtlState] = frozenset(
    {CtlState.FINISHED, CtlState.FAILED, CtlState.CANCELLED}
)

# The user-facing kill switch applies to every non-terminal state, and any
# state a live fleet run can leave a job in must be requeueable after a
# crash — those two families plus the nominal forward path give the table.
TRANSITIONS: Dict[CtlState, FrozenSet[CtlState]] = {
    CtlState.SUBMITTED: frozenset(
        {CtlState.ADMITTED, CtlState.PAUSED, CtlState.CANCELLED, CtlState.FAILED}
    ),
    CtlState.ADMITTED: frozenset(
        {
            CtlState.RUNNING,
            CtlState.PAGED,
            CtlState.MIGRATING,
            # a job may finish/fail inside its first observation epoch
            CtlState.FINISHED,
            CtlState.FAILED,
            CtlState.CANCELLED,
            CtlState.PAUSED,
            CtlState.SUBMITTED,  # crash-recovery requeue
        }
    ),
    CtlState.RUNNING: frozenset(
        {
            CtlState.PAUSED,
            CtlState.PAGED,
            CtlState.MIGRATING,
            CtlState.FINISHED,
            CtlState.FAILED,
            CtlState.CANCELLED,
            CtlState.SUBMITTED,  # crash-recovery requeue
        }
    ),
    CtlState.PAUSED: frozenset(
        {CtlState.SUBMITTED, CtlState.CANCELLED, CtlState.FAILED}
    ),
    CtlState.PAGED: frozenset(
        {
            CtlState.RUNNING,
            CtlState.MIGRATING,
            CtlState.PAUSED,
            CtlState.FINISHED,
            CtlState.FAILED,
            CtlState.CANCELLED,
            CtlState.SUBMITTED,  # crash-recovery requeue
        }
    ),
    CtlState.MIGRATING: frozenset(
        {
            CtlState.RUNNING,
            CtlState.PAGED,
            CtlState.PAUSED,
            CtlState.FINISHED,
            CtlState.FAILED,
            CtlState.CANCELLED,
            CtlState.SUBMITTED,  # crash-recovery requeue
        }
    ),
    CtlState.FINISHED: frozenset(),
    CtlState.FAILED: frozenset(),
    CtlState.CANCELLED: frozenset(),
}


class InvalidTransition(RuntimeError):
    """An illegal lifecycle hop — refused before anything is persisted."""


def is_terminal(state: CtlState) -> bool:
    return state in TERMINAL


def can_transition(src: CtlState, dst: CtlState) -> bool:
    return dst in TRANSITIONS[src]


def validate_transition(src: CtlState, dst: CtlState) -> None:
    """Raise :class:`InvalidTransition` unless ``src -> dst`` is legal."""
    if dst not in TRANSITIONS[src]:
        raise InvalidTransition(
            f"illegal transition {src.value} -> {dst.value}"
        )


# Engine JobState -> control-plane state, at epoch (quiescent-boundary)
# granularity. Engine READY/RUNNING/PAUSED are all "being scheduled":
# a policy preemption is not a user pause.
_ENGINE_TO_CTL: Dict[JobState, CtlState] = {
    JobState.QUEUED: CtlState.ADMITTED,
    JobState.READY: CtlState.RUNNING,
    JobState.RUNNING: CtlState.RUNNING,
    JobState.PAUSED: CtlState.RUNNING,
    JobState.PAGED: CtlState.PAGED,
    JobState.FINISHED: CtlState.FINISHED,
    JobState.FAILED: CtlState.FAILED,
    JobState.CANCELLED: CtlState.CANCELLED,
}


def ctl_state_of(engine_state: JobState, rejected: bool = False) -> CtlState:
    """Project an engine job state onto the lifecycle. In-engine rejection
    (P + E > C) marks the job FINISHED engine-side with ``stats.rejected``
    set; the control plane records that as FAILED — the job never ran and
    never will."""
    if rejected:
        return CtlState.FAILED
    return _ENGINE_TO_CTL[engine_state]
