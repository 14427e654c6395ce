"""repro_torch.ctl: the persistent control plane, the port's copy of the
JAX package's ``ctl``.

A long-lived scheduler daemon (:class:`CtlDaemon`) owning the port's
simulated :class:`~repro_torch.core.cluster.Cluster` behind a durable
SQLite :class:`JobStore`, with a validated job-lifecycle state machine
(:mod:`repro_torch.ctl.state_machine`) and the ``repro-ctl`` CLI
(:mod:`repro_torch.ctl.cli`, ``python -m repro_torch.ctl``) speaking
newline-delimited JSON over a unix socket. Epoch-boundary commits make a
SIGKILL at any instant lose at most the current epoch's uncommitted tail;
:meth:`CtlDaemon.recover` replays the persisted history and requeues
interrupted jobs from their last committed iteration. The store's schema
is the JAX package's, so either package opens, replays and recovers a
store the other wrote.
"""
from repro_torch.ctl.daemon import CtlClient, CtlDaemon, CtlError
from repro_torch.ctl.state_machine import (
    TRANSITIONS,
    CtlState,
    InvalidTransition,
    can_transition,
    ctl_state_of,
    is_terminal,
    validate_transition,
)
from repro_torch.ctl.store import (
    DuplicateJob,
    JobStore,
    StoreCorruption,
    spec_from_dict,
    spec_to_dict,
)

__all__ = [
    "CtlDaemon",
    "CtlClient",
    "CtlError",
    "CtlState",
    "TRANSITIONS",
    "InvalidTransition",
    "can_transition",
    "ctl_state_of",
    "is_terminal",
    "validate_transition",
    "JobStore",
    "DuplicateJob",
    "StoreCorruption",
    "spec_to_dict",
    "spec_from_dict",
]
