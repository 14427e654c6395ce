"""repro-lint: static analysis for the repo's determinism and lifecycle
contracts (``python -m repro_torch.analysis``).

The repo's core guarantee — bitwise-identical decision logs between the
simulator and the live executor, plus a crash-consistent control plane —
is enforced at runtime by the differential and chaos suites. This package
proves the cheap-to-check halves of those contracts *statically*, so a
violation is a red CI job at review time instead of a flaky differential
test after merge.

Rule families (full catalog in ROADMAP "Shipped subsystems"):

``RPL00x`` determinism lint (decision-path modules only)
    RPL001 wall-clock read, RPL002 unseeded RNG, RPL003 builtin
    ``hash()``, RPL004 order-sensitive iteration over a ``set``,
    RPL005 interprocedural taint — a clock/RNG value flowing through
    helpers, returns, or fields into a decision log, event ordinal,
    or ordering key.
``RPL01x`` enum/state exhaustiveness
    RPL010 non-exhaustive enum dispatch, RPL011 ctl lifecycle-table
    consistency (coverage, terminal absorption, requeue edges,
    reachability, ``ctl_state_of`` projection).
``RPL02x`` engine parity
    RPL020 event-kind emission parity between engine pairs
    (Simulator↔SalusExecutor, Cluster↔ClusterExecutor), RPL021 Engine
    protocol surface completeness.
``RPL03x`` store/lock discipline (``ctl/daemon.py``)
    RPL030 JobStore writes outside a crash-atomic transaction,
    RPL031 shared-state mutation outside the server lock.
``RPL04x`` concurrency (cross-file, on the shared call graph)
    RPL040 lock-order cycles across ``with``/``acquire`` sites
    (interprocedural, follows contextmanagers like
    ``store.transaction()``), RPL041 field access inconsistent with
    its inferred guarding lock, RPL042 blocking call (sleep / socket
    I/O / sqlite txn control) while holding a lock.

Intentional exceptions are suppressed in ``analysis.toml`` — every
suppression must carry a non-empty ``reason`` string.

This is the PyTorch port's copy of the JAX package's linter, standard
library only: its reports equal ``repro.analysis``'s on the same inputs,
and its builtin defaults name the port's modules. The port's own tree is
linted under ``analysis_torch.toml`` at the repo root.
"""

from repro_torch.analysis.base import Finding, Module, RULES
from repro_torch.analysis.config import AnalysisConfig, ConfigError, load_config
from repro_torch.analysis.runner import Report, run_analysis

__all__ = [
    "AnalysisConfig",
    "ConfigError",
    "Finding",
    "Module",
    "Report",
    "RULES",
    "load_config",
    "run_analysis",
]
