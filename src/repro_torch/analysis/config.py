"""``analysis.toml`` loading, builtin defaults, and suppression matching.

The shipped ``analysis.toml`` at the repo root is authoritative for CI.
Builtin defaults mirror it (minus suppressions) so ``python -m
repro_torch.analysis`` still runs sensibly from a bare checkout; a fixture tree
can override any knob with its own config file (see
``tests/fixtures/analysis/``).

Every suppression entry must carry a non-empty ``reason`` string — a
baseline without rationale defeats the point of the pass, so an empty
reason is a config error (exit code 2), not a warning.
"""
from __future__ import annotations

import fnmatch
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

try:  # py3.11+
    import tomllib as _toml
except ImportError:  # py3.10: pytest's bundled tomli dependency
    import tomli as _toml  # type: ignore[no-redef]

from repro_torch.analysis.base import RULES, Finding


class ConfigError(ValueError):
    """Malformed analysis.toml (reported as exit code 2)."""


@dataclass(frozen=True)
class Suppression:
    rule: str
    path: str  # posix relpath or glob, relative to the config root
    reason: str
    symbol: Optional[str] = None  # exact match on Finding.symbol when set

    def matches(self, finding: Finding) -> bool:
        if self.rule != finding.rule:
            return False
        if self.symbol is not None and self.symbol != finding.symbol:
            return False
        return _path_match(finding.path, self.path)


@dataclass(frozen=True)
class ParityPair:
    """One RPL020 comparison: enum references in ``left`` vs ``right``.

    Endpoints are ``path`` or ``path::ClassName`` (class-scoped when two
    engines share a file, e.g. Cluster and ClusterExecutor).
    """

    enum: str
    left: str
    right: str

    def endpoints(self) -> Tuple[Tuple[str, Optional[str]], Tuple[str, Optional[str]]]:
        return _split_endpoint(self.left), _split_endpoint(self.right)


def _split_endpoint(spec: str) -> Tuple[str, Optional[str]]:
    if "::" in spec:
        path, cls = spec.split("::", 1)
        return path, cls
    return spec, None


def _path_match(rel: str, pattern: str) -> bool:
    if pattern in (".", "", "*"):
        return True
    if pattern.endswith("/"):
        return rel.startswith(pattern)
    return rel == pattern or fnmatch.fnmatch(rel, pattern)


#: clock calls forbidden on decision paths (suffix match on the dotted
#: call). time.sleep is deliberately absent: it delays, it does not read.
DEFAULT_WALL_CLOCK_CALLS = (
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.localtime",
    "time.gmtime",
    "time.ctime",
    "datetime.now",
    "datetime.utcnow",
    "datetime.today",
    "date.today",
)

#: modules whose scheduling decisions must be a pure function of inputs
DEFAULT_DECISION_PATHS = (
    "src/repro_torch/core/scheduler.py",
    "src/repro_torch/core/memory.py",
    "src/repro_torch/core/lanes.py",
    "src/repro_torch/core/placement.py",
    "src/repro_torch/core/cluster.py",
    "src/repro_torch/core/simulator.py",
    "src/repro_torch/core/types.py",
    "src/repro_torch/core/engine.py",
    "src/repro_torch/ctl/",
)

DEFAULT_TRACKED_ENUMS = ("JobState", "MemoryEventKind", "CtlState", "PlacementEventKind")

DEFAULT_ENGINE_CLASSES = ("Simulator", "SalusExecutor", "Cluster", "ClusterExecutor")
DEFAULT_ENGINE_METHODS = ("submit", "run", "result", "decision_log")

DEFAULT_PARITY_PAIRS = (
    ParityPair(
        enum="MemoryEventKind",
        left="src/repro_torch/core/simulator.py",
        right="src/repro_torch/core/executor.py",
    ),
    ParityPair(
        enum="PlacementEventKind",
        left="src/repro_torch/core/cluster.py::Cluster",
        right="src/repro_torch/core/cluster.py::ClusterExecutor",
    ),
)

DEFAULT_DISCIPLINE_PATHS = ("src/repro_torch/ctl/daemon.py",)
DEFAULT_STORE_WRITE_METHODS = (
    "add_job",
    "set_state",
    "update_progress",
    "set_detail",
    "append_decisions",
    "set_meta",
)
DEFAULT_LOCK_ATTR = "_ctl_lock"
DEFAULT_LOCKED_ATTRS = (
    "_active",
    "_pending_cancel",
    "_pending_pause",
    "_terminal_committed",
)

#: modules the RPL04x concurrency family analyzes (the lock-laden shared
#: infrastructure; single-threaded library code would only add noise)
DEFAULT_CONCURRENCY_PATHS = ("src/repro_torch/core/", "src/repro_torch/ctl/")

#: callables whose result is a lock (matched on the dotted tail)
DEFAULT_LOCK_FACTORIES = (
    "Lock",
    "RLock",
    "Condition",
    "Semaphore",
    "BoundedSemaphore",
)

#: dotted-call suffixes that block the calling thread (RPL042).
#: ``join`` covers thread/process joins (a join under a lock the worker
#: needs to make progress is a deadlock, not a slow hold — the fleet
#: driver's close() releases its condition before joining for exactly
#: this reason); str.join never fires because a Constant receiver has no
#: dotted name.
DEFAULT_BLOCKING_CALLS = (
    "time.sleep",
    "serve_forever",
    "select.select",
    "subprocess.run",
    "subprocess.check_call",
    "subprocess.check_output",
    "join",
)

#: method names that block on a peer or the disk (RPL042); sqlite
#: transaction control via execute("BEGIN/COMMIT/ROLLBACK ...") is
#: detected separately
DEFAULT_BLOCKING_ATTRS = (
    "recv",
    "recv_into",
    "send",
    "sendall",
    "accept",
    "connect",
    "commit",
)

#: attribute names treated as decision logs by the RPL005 taint pass
DEFAULT_TAINT_LOG_NAMES = ("decision_log", "decisions", "events", "placement_log")

#: method names whose arguments are decision-log writes (RPL005)
DEFAULT_TAINT_SINK_CALLS = ("append_decisions",)

#: substrings marking an assignment target as an event ordinal (RPL005)
DEFAULT_TAINT_ORDINAL_MARKERS = ("ordinal", "seq_no", "event_seq")


@dataclass
class AnalysisConfig:
    root: Path = field(default_factory=Path.cwd)
    decision_paths: Tuple[str, ...] = DEFAULT_DECISION_PATHS
    tracked_enums: Tuple[str, ...] = DEFAULT_TRACKED_ENUMS
    lifecycle_enum: str = "CtlState"
    initial_state: str = "SUBMITTED"
    engine_classes: Tuple[str, ...] = DEFAULT_ENGINE_CLASSES
    engine_methods: Tuple[str, ...] = DEFAULT_ENGINE_METHODS
    wall_clock_calls: Tuple[str, ...] = DEFAULT_WALL_CLOCK_CALLS
    parity_pairs: Tuple[ParityPair, ...] = DEFAULT_PARITY_PAIRS
    discipline_paths: Tuple[str, ...] = DEFAULT_DISCIPLINE_PATHS
    store_write_methods: Tuple[str, ...] = DEFAULT_STORE_WRITE_METHODS
    lock_attr: str = DEFAULT_LOCK_ATTR
    locked_attrs: Tuple[str, ...] = DEFAULT_LOCKED_ATTRS
    concurrency_paths: Tuple[str, ...] = DEFAULT_CONCURRENCY_PATHS
    lock_factories: Tuple[str, ...] = DEFAULT_LOCK_FACTORIES
    blocking_calls: Tuple[str, ...] = DEFAULT_BLOCKING_CALLS
    blocking_attrs: Tuple[str, ...] = DEFAULT_BLOCKING_ATTRS
    taint_log_names: Tuple[str, ...] = DEFAULT_TAINT_LOG_NAMES
    taint_sink_calls: Tuple[str, ...] = DEFAULT_TAINT_SINK_CALLS
    taint_ordinal_markers: Tuple[str, ...] = DEFAULT_TAINT_ORDINAL_MARKERS
    suppressions: Tuple[Suppression, ...] = ()

    def is_decision_path(self, rel: str) -> bool:
        return any(_path_match(rel, p) for p in self.decision_paths)

    def is_discipline_path(self, rel: str) -> bool:
        return any(_path_match(rel, p) for p in self.discipline_paths)

    def is_concurrency_path(self, rel: str) -> bool:
        return any(_path_match(rel, p) for p in self.concurrency_paths)


def _str_tuple(raw: Any, key: str) -> Tuple[str, ...]:
    if not isinstance(raw, list) or not all(isinstance(x, str) for x in raw):
        raise ConfigError(f"[analysis] {key} must be a list of strings")
    return tuple(raw)


def load_config(path: Optional[Path]) -> AnalysisConfig:
    """Load ``analysis.toml`` (or builtin defaults when ``path`` is None)."""
    if path is None:
        return AnalysisConfig()
    path = Path(path)
    try:
        data = _toml.loads(path.read_text(encoding="utf-8"))
    except OSError as e:
        raise ConfigError(f"cannot read {path}: {e}") from e
    except _toml.TOMLDecodeError as e:
        raise ConfigError(f"{path}: {e}") from e

    cfg = AnalysisConfig(root=path.resolve().parent)
    section = data.get("analysis", {})
    if not isinstance(section, dict):
        raise ConfigError("[analysis] must be a table")

    simple = {
        "decision_paths": "decision_paths",
        "tracked_enums": "tracked_enums",
        "engine_classes": "engine_classes",
        "engine_methods": "engine_methods",
        "wall_clock_calls": "wall_clock_calls",
    }
    for toml_key, attr in simple.items():
        if toml_key in section:
            setattr(cfg, attr, _str_tuple(section[toml_key], toml_key))
    if "lifecycle_enum" in section:
        cfg.lifecycle_enum = str(section["lifecycle_enum"])
    if "initial_state" in section:
        cfg.initial_state = str(section["initial_state"])

    if "parity" in section:
        pairs: List[ParityPair] = []
        for i, entry in enumerate(section["parity"]):
            try:
                pairs.append(
                    ParityPair(
                        enum=entry["enum"], left=entry["left"], right=entry["right"]
                    )
                )
            except (KeyError, TypeError) as e:
                raise ConfigError(
                    f"[[analysis.parity]] #{i}: needs enum/left/right ({e})"
                ) from e
        cfg.parity_pairs = tuple(pairs)

    disc = section.get("discipline", {})
    if not isinstance(disc, dict):
        raise ConfigError("[analysis.discipline] must be a table")
    if "paths" in disc:
        cfg.discipline_paths = _str_tuple(disc["paths"], "discipline.paths")
    if "store_write_methods" in disc:
        cfg.store_write_methods = _str_tuple(
            disc["store_write_methods"], "discipline.store_write_methods"
        )
    if "lock_attr" in disc:
        cfg.lock_attr = str(disc["lock_attr"])
    if "locked_attrs" in disc:
        cfg.locked_attrs = _str_tuple(disc["locked_attrs"], "discipline.locked_attrs")

    conc = section.get("concurrency", {})
    if not isinstance(conc, dict):
        raise ConfigError("[analysis.concurrency] must be a table")
    for toml_key, attr in (
        ("paths", "concurrency_paths"),
        ("lock_factories", "lock_factories"),
        ("blocking_calls", "blocking_calls"),
        ("blocking_attrs", "blocking_attrs"),
    ):
        if toml_key in conc:
            setattr(cfg, attr, _str_tuple(conc[toml_key], f"concurrency.{toml_key}"))

    taint = section.get("taint", {})
    if not isinstance(taint, dict):
        raise ConfigError("[analysis.taint] must be a table")
    for toml_key, attr in (
        ("log_names", "taint_log_names"),
        ("sink_calls", "taint_sink_calls"),
        ("ordinal_markers", "taint_ordinal_markers"),
    ):
        if toml_key in taint:
            setattr(cfg, attr, _str_tuple(taint[toml_key], f"taint.{toml_key}"))

    sups: List[Suppression] = []
    for i, entry in enumerate(data.get("suppress", [])):
        if not isinstance(entry, dict):
            raise ConfigError(f"[[suppress]] #{i} must be a table")
        rule = entry.get("rule")
        if rule not in RULES:
            raise ConfigError(f"[[suppress]] #{i}: unknown rule {rule!r}")
        reason = entry.get("reason")
        if not isinstance(reason, str) or not reason.strip():
            raise ConfigError(
                f"[[suppress]] #{i} ({rule}): a non-empty reason string is required"
            )
        sups.append(
            Suppression(
                rule=rule,
                path=str(entry.get("path", "*")),
                reason=reason,
                symbol=entry.get("symbol"),
            )
        )
    cfg.suppressions = tuple(sups)
    return cfg
