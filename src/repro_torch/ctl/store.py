"""Durable SQLite job store for the control-plane daemon (the port's copy
of the JAX package's ``ctl/store.py``: the same schema, so a store written
by either package opens, replays and recovers in the other).

One database file holds everything the daemon needs to survive a SIGKILL:

``jobs``
    One row per job: the serialized :class:`~repro_torch.core.types.JobSpec`,
    the current lifecycle state, and ``iterations_done`` — the highest
    iteration count *committed* at a quiescent epoch boundary. On
    recovery a job resumes from exactly this boundary
    (``Cluster.run(resume_done=...)``); work past it that the dead
    process had executed but not committed is re-run, work before it is
    never re-run, so no iteration is ever double-counted in the store.

``transitions``
    Append-only lifecycle history: ``(seq, job_id, src, dst, at,
    reason)``. Every write is validated against
    :mod:`repro_torch.ctl.state_machine` *before* it is persisted, and
    :meth:`JobStore.replay` re-folds the whole table through the same
    machine — a corrupt or hand-edited store fails loudly instead of
    resurrecting finished jobs.

``decisions``
    Append-only engine decision log: placement events and per-device
    memory-manager events, JSON-encoded via
    :func:`repro_torch.core.engine.encode_decision`. The daemon appends only
    the per-epoch *suffix* inside the same transaction as that epoch's
    progress, so after a crash the persisted log is always a prefix of
    what the engine produced — the chaos tests assert exactly this.

``meta``
    Key/value scratch, including the durable ``next_job_id`` counter:
    job ids are allocated by the store, not by ``JobSpec``'s
    process-local ``itertools.count``, so ids never collide across
    daemon restarts.

All writes go through one connection guarded by an RLock (the daemon's
socket handlers and scheduler thread share the store); WAL journaling
keeps a reader (``repro-ctl status`` run against the db directly, or a
chaos test peeking mid-run) consistent while the daemon commits.
"""
from __future__ import annotations

import json
import sqlite3
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.core.engine import decode_decision, encode_decision
from repro_torch.core.types import JobSpec, MemoryProfile
from repro_torch.ctl.state_machine import (
    CtlState,
    InvalidTransition,
    is_terminal,
    validate_transition,
)

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
    job_id          INTEGER PRIMARY KEY,
    name            TEXT NOT NULL,
    spec            TEXT NOT NULL,
    state           TEXT NOT NULL,
    iterations_done INTEGER NOT NULL DEFAULT 0,
    n_iters         INTEGER NOT NULL,
    detail          TEXT NOT NULL DEFAULT '',
    submitted_at    REAL NOT NULL,
    updated_at      REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS transitions (
    seq     INTEGER PRIMARY KEY AUTOINCREMENT,
    job_id  INTEGER NOT NULL,
    src     TEXT,
    dst     TEXT NOT NULL,
    at      REAL NOT NULL,
    reason  TEXT NOT NULL DEFAULT ''
);
CREATE TABLE IF NOT EXISTS decisions (
    seq     INTEGER PRIMARY KEY AUTOINCREMENT,
    source  TEXT NOT NULL,
    entry   TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS meta (
    key   TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
"""


class StoreCorruption(RuntimeError):
    """The persisted lifecycle history does not replay cleanly."""


class DuplicateJob(ValueError):
    """A job_id already present in the store was submitted again."""


def spec_to_dict(job: JobSpec) -> Dict[str, Any]:
    """JSON-serializable projection of a JobSpec. ``run_iteration`` (a
    live-execution callable) cannot cross the persistence boundary — the
    daemon schedules trace jobs, which is the paper's evaluation regime —
    and ``meta`` is kept only when it serializes."""
    d: Dict[str, Any] = {
        "job_id": job.job_id,
        "name": job.name,
        "persistent": job.profile.persistent,
        "ephemeral": job.profile.ephemeral,
        "n_iters": job.n_iters,
        "iter_time": job.iter_time,
        "utilization": job.utilization,
        "arrival_time": job.arrival_time,
        "kind": job.kind,
        "priority": job.priority,
        "request_times": list(job.request_times) if job.request_times else None,
    }
    try:
        d["meta"] = json.loads(json.dumps(job.meta))
    except (TypeError, ValueError):
        d["meta"] = {}
    return d


def spec_from_dict(d: Dict[str, Any]) -> JobSpec:
    """Rebuild a JobSpec from its stored form, pinning the store-assigned
    job_id (JobSpec's own counter is process-local and must not win)."""
    job = JobSpec(
        name=d["name"],
        profile=MemoryProfile(int(d["persistent"]), int(d["ephemeral"])),
        n_iters=int(d["n_iters"]),
        iter_time=float(d["iter_time"]),
        utilization=float(d.get("utilization", 1.0)),
        arrival_time=float(d.get("arrival_time", 0.0)),
        kind=d.get("kind", "train"),
        priority=d.get("priority"),
        request_times=(
            tuple(d["request_times"]) if d.get("request_times") else None
        ),
        meta=dict(d.get("meta") or {}),
    )
    job.job_id = int(d["job_id"])
    return job


class JobStore:
    """Crash-safe job + decision-log store (SQLite, WAL)."""

    def __init__(self, path: str, timeout: float = 30.0) -> None:
        self.path = path
        self._lock = threading.RLock()
        # isolation_level=None -> autocommit; explicit transactions via
        # the transaction() contextmanager (BEGIN IMMEDIATE) so an epoch
        # commit is one atomic unit even across many method calls.
        self._conn = sqlite3.connect(
            path, timeout=timeout, check_same_thread=False, isolation_level=None
        )
        self._conn.row_factory = sqlite3.Row
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        with self._lock:
            self._conn.executescript(_SCHEMA)

    def close(self) -> None:
        with self._lock:
            self._conn.close()

    # -- transactions ----------------------------------------------------

    @contextmanager
    def transaction(self) -> Iterator["JobStore"]:
        """One atomic unit; nests (inner blocks join the outer one)."""
        with self._lock:
            if self._conn.in_transaction:
                yield self
                return
            self._conn.execute("BEGIN IMMEDIATE")
            try:
                yield self
            except BaseException:
                self._conn.execute("ROLLBACK")
                raise
            self._conn.execute("COMMIT")

    # -- id allocation ---------------------------------------------------

    def next_job_id(self) -> int:
        with self.transaction():
            row = self._conn.execute(
                "SELECT value FROM meta WHERE key = 'next_job_id'"
            ).fetchone()
            nxt = int(row["value"]) if row is not None else 0
            self._conn.execute(
                "INSERT INTO meta (key, value) VALUES ('next_job_id', ?) "
                "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                (str(nxt + 1),),
            )
            return nxt

    # -- job lifecycle ---------------------------------------------------

    def add_job(self, spec_dict: Dict[str, Any], now: Optional[float] = None) -> int:
        """Record a freshly submitted job (initial state SUBMITTED, with
        its creation transition). Raises :class:`DuplicateJob` if the id
        is already present — the duplicate-submit guard at the durable
        layer, mirroring the in-engine ``submit`` guards."""
        now = time.time() if now is None else now
        job_id = int(spec_dict["job_id"])
        with self.transaction():
            dup = self._conn.execute(
                "SELECT 1 FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
            if dup is not None:
                raise DuplicateJob(
                    f"duplicate job_id {job_id} "
                    f"({spec_dict.get('name')!r}): already in store"
                )
            self._conn.execute(
                "INSERT INTO jobs (job_id, name, spec, state, iterations_done,"
                " n_iters, submitted_at, updated_at)"
                " VALUES (?, ?, ?, ?, 0, ?, ?, ?)",
                (
                    job_id,
                    spec_dict["name"],
                    json.dumps(spec_dict),
                    CtlState.SUBMITTED.value,
                    int(spec_dict["n_iters"]),
                    now,
                    now,
                ),
            )
            self._conn.execute(
                "INSERT INTO transitions (job_id, src, dst, at, reason)"
                " VALUES (?, NULL, ?, ?, 'submit')",
                (job_id, CtlState.SUBMITTED.value, now),
            )
        return job_id

    def get_job(self, job_id: int) -> Optional[Dict[str, Any]]:
        with self._lock:
            row = self._conn.execute(
                "SELECT * FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
        return self._job_dict(row) if row is not None else None

    def list_jobs(
        self, states: Optional[Iterable[CtlState]] = None
    ) -> List[Dict[str, Any]]:
        with self._lock:
            if states is None:
                rows = self._conn.execute(
                    "SELECT * FROM jobs ORDER BY job_id"
                ).fetchall()
            else:
                vals = [s.value for s in states]
                marks = ",".join("?" for _ in vals)
                rows = self._conn.execute(
                    f"SELECT * FROM jobs WHERE state IN ({marks}) ORDER BY job_id",
                    vals,
                ).fetchall()
        return [self._job_dict(r) for r in rows]

    @staticmethod
    def _job_dict(row: sqlite3.Row) -> Dict[str, Any]:
        d = dict(row)
        d["spec"] = json.loads(d["spec"])
        d["state"] = CtlState(d["state"])
        return d

    def set_state(
        self,
        job_id: int,
        dst: CtlState,
        reason: str = "",
        now: Optional[float] = None,
    ) -> None:
        """Validated lifecycle write: current-state -> ``dst`` must be a
        legal edge or :class:`InvalidTransition` aborts before anything is
        persisted. A same-state write is a no-op (epoch commits observe
        most jobs in an unchanged state)."""
        now = time.time() if now is None else now
        with self.transaction():
            row = self._conn.execute(
                "SELECT state FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
            if row is None:
                raise KeyError(f"unknown job {job_id}")
            src = CtlState(row["state"])
            if src is dst:
                return
            validate_transition(src, dst)
            self._conn.execute(
                "UPDATE jobs SET state = ?, updated_at = ? WHERE job_id = ?",
                (dst.value, now, job_id),
            )
            self._conn.execute(
                "INSERT INTO transitions (job_id, src, dst, at, reason)"
                " VALUES (?, ?, ?, ?, ?)",
                (job_id, src.value, dst.value, now, reason),
            )

    def update_progress(
        self, job_id: int, done: int, now: Optional[float] = None
    ) -> None:
        """Advance the committed iteration boundary. Progress is monotone:
        a smaller value than what is stored is refused — recovery replays
        work *forward* from the committed boundary, never backward."""
        now = time.time() if now is None else now
        with self.transaction():
            row = self._conn.execute(
                "SELECT iterations_done FROM jobs WHERE job_id = ?", (job_id,)
            ).fetchone()
            if row is None:
                raise KeyError(f"unknown job {job_id}")
            if done < row["iterations_done"]:
                raise StoreCorruption(
                    f"job {job_id}: progress would move backward "
                    f"({row['iterations_done']} -> {done})"
                )
            if done != row["iterations_done"]:
                self._conn.execute(
                    "UPDATE jobs SET iterations_done = ?, updated_at = ?"
                    " WHERE job_id = ?",
                    (done, now, job_id),
                )

    def set_detail(self, job_id: int, detail: str) -> None:
        with self.transaction():
            self._conn.execute(
                "UPDATE jobs SET detail = ? WHERE job_id = ?", (detail, job_id)
            )

    # -- decision log ----------------------------------------------------

    def append_decisions(self, source: str, entries: Iterable[tuple]) -> int:
        """Append engine decision entries (tuples, enum members allowed)
        under ``source`` ('placement' or 'device:<i>'). Returns how many
        rows were written."""
        rows = [(source, json.dumps(encode_decision(e))) for e in entries]
        if not rows:
            return 0
        with self.transaction():
            self._conn.executemany(
                "INSERT INTO decisions (source, entry) VALUES (?, ?)", rows
            )
        return len(rows)

    def decision_log(self, source: Optional[str] = None) -> List[tuple]:
        with self._lock:
            if source is None:
                rows = self._conn.execute(
                    "SELECT entry FROM decisions ORDER BY seq"
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT entry FROM decisions WHERE source = ? ORDER BY seq",
                    (source,),
                ).fetchall()
        return [decode_decision(json.loads(r["entry"])) for r in rows]

    def decision_count(self, source: Optional[str] = None) -> int:
        with self._lock:
            if source is None:
                row = self._conn.execute(
                    "SELECT COUNT(*) AS n FROM decisions"
                ).fetchone()
            else:
                row = self._conn.execute(
                    "SELECT COUNT(*) AS n FROM decisions WHERE source = ?",
                    (source,),
                ).fetchone()
        return int(row["n"])

    def decision_sources(self) -> List[str]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT DISTINCT source FROM decisions ORDER BY source"
            ).fetchall()
        return [r["source"] for r in rows]

    # -- meta ------------------------------------------------------------

    def get_meta(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            row = self._conn.execute(
                "SELECT value FROM meta WHERE key = ?", (key,)
            ).fetchone()
        return row["value"] if row is not None else default

    def set_meta(self, key: str, value: str) -> None:
        with self.transaction():
            self._conn.execute(
                "INSERT INTO meta (key, value) VALUES (?, ?)"
                " ON CONFLICT(key) DO UPDATE SET value = excluded.value",
                (key, value),
            )

    # -- recovery / validation -------------------------------------------

    def replay(self) -> Dict[int, CtlState]:
        """Fold the full transition history through the state machine and
        cross-check it against the ``jobs`` table. This is the recovery
        entry point: a store whose history contains an illegal hop, whose
        final replayed state disagrees with the jobs row, or whose
        committed progress overruns ``n_iters`` raises
        :class:`StoreCorruption` instead of silently rescheduling."""
        with self._lock:
            trows = self._conn.execute(
                "SELECT job_id, src, dst FROM transitions ORDER BY seq"
            ).fetchall()
            jrows = self._conn.execute(
                "SELECT job_id, state, iterations_done, n_iters FROM jobs"
            ).fetchall()
        states: Dict[int, CtlState] = {}
        for r in trows:
            jid, src, dst = r["job_id"], r["src"], CtlState(r["dst"])
            cur = states.get(jid)
            if src is None:
                if cur is not None:
                    raise StoreCorruption(
                        f"job {jid}: second creation transition in history"
                    )
                if dst is not CtlState.SUBMITTED:
                    raise StoreCorruption(
                        f"job {jid}: created in state {dst.value}"
                    )
            else:
                if cur is None:
                    raise StoreCorruption(
                        f"job {jid}: transition before creation"
                    )
                if cur is not CtlState(src):
                    raise StoreCorruption(
                        f"job {jid}: history src {src} != replayed {cur.value}"
                    )
                try:
                    validate_transition(cur, dst)
                except InvalidTransition as e:
                    raise StoreCorruption(f"job {jid}: {e}") from e
            states[jid] = dst
        for r in jrows:
            jid = r["job_id"]
            if jid not in states:
                raise StoreCorruption(f"job {jid}: no transition history")
            if states[jid] is not CtlState(r["state"]):
                raise StoreCorruption(
                    f"job {jid}: jobs.state {r['state']} != replayed "
                    f"{states[jid].value}"
                )
            if r["iterations_done"] > r["n_iters"]:
                raise StoreCorruption(
                    f"job {jid}: committed progress {r['iterations_done']} "
                    f"> n_iters {r['n_iters']}"
                )
        return states

    def transitions(self, job_id: Optional[int] = None) -> List[Tuple]:
        with self._lock:
            if job_id is None:
                rows = self._conn.execute(
                    "SELECT job_id, src, dst, at, reason FROM transitions"
                    " ORDER BY seq"
                ).fetchall()
            else:
                rows = self._conn.execute(
                    "SELECT job_id, src, dst, at, reason FROM transitions"
                    " WHERE job_id = ? ORDER BY seq",
                    (job_id,),
                ).fetchall()
        return [tuple(r) for r in rows]

    def counts(self) -> Dict[str, int]:
        with self._lock:
            rows = self._conn.execute(
                "SELECT state, COUNT(*) AS n FROM jobs GROUP BY state"
            ).fetchall()
        return {r["state"]: int(r["n"]) for r in rows}

    def all_terminal(self) -> bool:
        return all(is_terminal(CtlState(s)) for s in self.counts())
