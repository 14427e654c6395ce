"""The Engine surface shared by the port's execution backends (copy of the
JAX package's ``core/engine.py``).

Engines — the discrete-event :class:`~repro_torch.core.simulator.Simulator`
and the live :class:`~repro_torch.core.executor.SalusExecutor` — satisfy
the :class:`Engine` protocol (``submit`` / ``run`` / ``result`` /
``decision_log``), so tests can be written once against the protocol and
handed either backend. :class:`ResultSurface` defines the canonical
accessor set (``jcts`` / ``avg_jct`` / ``p95_jct`` / ``utilization`` /
``completed`` / ``per_job`` / ``request_latencies``) computed from per-job
:class:`JobStats` and a makespan. ``decision_log`` appears both as a dataclass *field*
(``res.decision_log == [...]``) and as the engine's *method*
(``engine.decision_log()``); :class:`DecisionLog` — a list that is also
callable, returning its own entries — bridges the two.
"""
from __future__ import annotations

import enum
from typing import Any, Dict, List, Protocol, Sequence, runtime_checkable

from repro_torch.core.types import IterationRecord, JobStats, percentile


@runtime_checkable
class Engine(Protocol):
    """What every execution backend speaks: submit work, run it, read the
    result, inspect the decision sequence. ``run`` signatures differ per
    backend (traces vs sessions, ``until`` vs ``max_wall``), so the
    protocol only pins the method names; the *result* shape is unified via
    :class:`ResultSurface` instead."""

    def submit(self, work: Any) -> None: ...

    def run(self, *args: Any, **kwargs: Any) -> Any: ...

    def result(self) -> Any: ...

    def decision_log(self) -> List[tuple]: ...


class DecisionLog(list):
    """A decision-log value usable both as a plain list (``==``, ``in``,
    indexing) and as a zero-argument callable (``decision_log()``)."""

    def __call__(self) -> List[tuple]:
        return list(self)


def encode_decision(entry: Sequence[Any]) -> List[Any]:
    """JSON-able form of one decision-log entry. Engine logs are tuples of
    primitives (kind, ordinal, name, lane/device); enums are flattened to
    their values so a persisted log is stable across enum identity."""
    return [x.value if isinstance(x, enum.Enum) else x for x in entry]


def decode_decision(obj: Sequence[Any]) -> tuple:
    """Inverse of :func:`encode_decision` up to enum flattening: a JSON
    round-trip turns tuples into lists, so a reader re-tuples them before
    comparing against a live engine's ``decision_log()`` entries."""
    return tuple(obj)


def encode_decision_log(entries: Sequence[Sequence[Any]]) -> List[List[Any]]:
    return [encode_decision(e) for e in entries]


def decode_decision_log(objs: Sequence[Sequence[Any]]) -> List[tuple]:
    return [decode_decision(o) for o in objs]


def busy_seconds(records: Sequence[IterationRecord]) -> float:
    """Total device-busy time: union of iteration intervals (lanes overlap
    under concurrent policies, so plain summation overcounts)."""
    spans = sorted((r.start, r.end) for r in records)
    total, cur_start, cur_end = 0.0, None, None
    for s, e in spans:
        if cur_end is None or s > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = s, e
        else:
            cur_end = max(cur_end, e)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


class ResultSurface:
    """Shared accessors over the facts every engine result carries.

    Requires the mixing class to provide ``stats`` (job_id ->
    :class:`JobStats`), ``records`` (iteration records), and ``makespan``.
    """

    stats: Dict[int, JobStats]
    records: List[IterationRecord]
    makespan: float

    @property
    def per_job(self) -> Dict[int, JobStats]:
        """Canonical name for the per-job stats mapping."""
        return self.stats

    @property
    def jcts(self) -> List[float]:
        return [s.jct for s in self.stats.values() if s.jct is not None]

    @property
    def avg_jct(self) -> float:
        v = self.jcts
        return sum(v) / len(v) if v else 0.0

    @property
    def p95_jct(self) -> float:
        # nearest-rank, shared with JobStats via types.percentile
        v = percentile(self.jcts, 0.95)
        return 0.0 if v is None else v

    @property
    def utilization(self) -> float:
        """Busy fraction of the device over the makespan."""
        span = self.makespan
        if span <= 0.0:
            return 0.0
        return busy_seconds(self.records) / span

    @property
    def completed(self) -> int:
        return sum(1 for s in self.stats.values() if s.finish_time is not None)

    @property
    def request_latencies(self) -> List[float]:
        """All open-loop request latencies across jobs (queueing + service)."""
        out: List[float] = []
        for s in self.stats.values():
            out.extend(s.request_latencies)
        return out
