"""Result surface shared by the executor's reports (copy of the JAX
package's ``core/engine.py``, reduced to what the live executor uses).

:class:`ResultSurface` defines the canonical accessor set (``jcts`` /
``avg_jct`` / ``p95_jct`` / ``utilization`` / ``completed`` / ``per_job``
/ ``request_latencies``) computed from per-job :class:`JobStats` and a
makespan. ``decision_log`` appears both as a dataclass *field*
(``res.decision_log == [...]``) and as the engine's *method*
(``engine.decision_log()``); :class:`DecisionLog` — a list that is also
callable, returning its own entries — bridges the two.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

from repro_torch.core.types import IterationRecord, JobStats, percentile


class DecisionLog(list):
    """A decision-log value usable both as a plain list (``==``, ``in``,
    indexing) and as a zero-argument callable (``decision_log()``)."""

    def __call__(self) -> List[tuple]:
        return list(self)


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
