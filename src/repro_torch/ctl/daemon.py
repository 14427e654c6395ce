"""The persistent control-plane daemon (the port's copy of the JAX
package's ``ctl/daemon.py``, over the port's simulated ``Cluster``: it
takes no device).

One long-lived process owns a :class:`~repro_torch.core.cluster.Cluster` (an
:class:`~repro_torch.core.engine.Engine`) plus the durable
:class:`~repro_torch.ctl.store.JobStore`, and exposes
submit/status/cancel/pause/resume/drain over a local unix socket
(newline-delimited JSON; see :mod:`repro_torch.ctl.cli`).

Execution model
---------------
A scheduler thread claims every SUBMITTED job in the store as one *fleet
run*: a fresh ``Cluster`` with ``rebalance_interval=epoch`` and an
``on_epoch`` persistence callback. At every quiescent epoch boundary the
callback commits — in **one** SQLite transaction — the fleet's progress,
the decision-log *suffixes* since the previous boundary (placement events
+ per-device memory-manager events), and any lifecycle transitions the
epoch observed. Control commands against running jobs (cancel/pause) are
queued and applied at the next boundary through
:class:`~repro_torch.core.cluster.EpochControl`, where the fleet is drained and
eviction is safe.

Crash recovery
--------------
Because the store only ever moves forward at epoch boundaries, a SIGKILL
at any instant loses at most the uncommitted tail of the current epoch.
On restart :meth:`CtlDaemon.recover` first *replays* the persisted
transition history through the lifecycle state machine (store corruption
fails loudly), then requeues every job a dead fleet run owned
(ADMITTED/RUNNING/PAGED/MIGRATING -> SUBMITTED); the next fleet run
resumes each from its committed ``iterations_done`` boundary via
``Cluster.run(resume_done=...)``. Committed iterations are never re-run
against the store, uncommitted ones are re-executed and committed once —
so the persisted decision log and iteration counts evolve strictly by
extension (the chaos tests assert prefix-consistency around a kill).

For in-process chaos testing a
:class:`~repro_torch.dist.fault.FailureInjector` can be attached: it fires at
epoch *commit points* (``maybe_fail(epoch_seq)`` just before the
transaction), modeling a hard crash between epochs, and composes with
:class:`~repro_torch.dist.fault.RestartSupervisor` driving
:meth:`run_pending_fleets` synchronously.
"""
from __future__ import annotations

import json
import os
import socket
import socketserver
import threading
import time
import traceback
from typing import Any, Dict, List, Optional, Set, Tuple

from repro_torch.core.cluster import Cluster, ClusterResult, EpochControl, EpochSnapshot
from repro_torch.core.events import EpochSchedule
from repro_torch.core.memory import MemoryConfig
from repro_torch.core.placement import Rebalancer
from repro_torch.core.types import GB, JobSpec, JobState
from repro_torch.ctl.state_machine import (
    CtlState,
    InvalidTransition,
    ctl_state_of,
    is_terminal,
)
from repro_torch.ctl.store import JobStore, spec_from_dict
from repro_torch.dist.fault import InjectedFailure

_ACTIVE_STATES = (
    CtlState.SUBMITTED,
    CtlState.ADMITTED,
    CtlState.RUNNING,
    CtlState.PAGED,
    CtlState.MIGRATING,
)


class CtlError(RuntimeError):
    """A command-level error returned to the client as ``ok: false``."""


class CtlDaemon:
    """Scheduler daemon: durable store + engine fleet runs + socket API."""

    def __init__(
        self,
        store: "JobStore | str",
        socket_path: Optional[str] = None,
        n_devices: int = 1,
        capacity: int = 8 * GB,
        policy: str = "fifo",
        strategy: str = "least_loaded",
        paging: bool = False,
        page_bandwidth: float = 12 * GB,
        epoch: float = 60.0,
        rebalance_mode: str = "none",
        epoch_sleep: float = 0.0,
        fault_injector: Optional[Any] = None,
        poll_interval: float = 0.05,
    ) -> None:
        self.store = store if isinstance(store, JobStore) else JobStore(store)
        self.socket_path = socket_path
        self.n_devices = n_devices
        self.capacity = capacity
        self.policy = policy
        self.strategy = strategy
        self.paging = paging
        self.page_bandwidth = page_bandwidth
        self.epoch = epoch
        self.rebalance_mode = rebalance_mode
        self.epoch_sleep = epoch_sleep
        self.fault_injector = fault_injector
        self.poll_interval = poll_interval

        self._ctl_lock = threading.RLock()
        self._active: Set[int] = set()  # job_ids owned by the live fleet run
        self._pending_cancel: Set[int] = set()
        self._pending_pause: Set[int] = set()
        self._terminal_committed: Set[int] = set()
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._draining = False
        self._server: Optional[socketserver.BaseServer] = None
        self._sched_thread: Optional[threading.Thread] = None
        self._epoch_seq = 0  # monotone across fleet runs in this process
        self._fleet_runs = 0
        # per-fleet-run decision-log offsets (the store is cumulative
        # across runs; these index into the *current* engine's logs)
        self._off_placement = 0
        self._off_devices: List[int] = []

    # ------------------------------------------------------------------
    # Recovery
    # ------------------------------------------------------------------

    def recover(self) -> List[int]:
        """Validate the store by full history replay, then requeue every
        job a dead fleet run owned. Returns the requeued job_ids."""
        self.store.replay()
        requeued: List[int] = []
        # one transaction: recovery is all-or-nothing, so a crash *during*
        # recovery can never leave half the dead fleet requeued (RPL030)
        with self.store.transaction():
            for row in self.store.list_jobs():
                st: CtlState = row["state"]
                if st not in (
                    CtlState.ADMITTED,
                    CtlState.RUNNING,
                    CtlState.PAGED,
                    CtlState.MIGRATING,
                ):
                    continue  # terminal, PAUSED and SUBMITTED survive as-is
                jid = row["job_id"]
                if row["iterations_done"] >= row["n_iters"]:
                    # the final iteration was committed but the FINISHED write
                    # was lost with the crash — finish, don't re-run
                    self.store.set_state(
                        jid,
                        CtlState.FINISHED,
                        reason="recovery: all iterations committed",
                    )
                else:
                    self.store.set_state(
                        jid, CtlState.SUBMITTED, reason="crash-recovery requeue"
                    )
                    requeued.append(jid)
        return requeued

    # ------------------------------------------------------------------
    # Fleet runs
    # ------------------------------------------------------------------

    def run_pending_fleets(self, max_runs: Optional[int] = None) -> int:
        """Synchronously drain SUBMITTED jobs through fleet runs (the
        scheduler thread's body; also the entry point for in-process chaos
        tests, where an attached FailureInjector's InjectedFailure
        propagates out of here like a crash). Returns fleet runs done."""
        runs = 0
        while not self._stop.is_set():
            batch = self._claim_batch()
            if not batch:
                break
            self._run_fleet(batch)
            runs += 1
            if max_runs is not None and runs >= max_runs:
                break
        return runs

    def _claim_batch(self) -> List[Tuple[JobSpec, int]]:
        with self._ctl_lock:
            batch: List[Tuple[JobSpec, int]] = []
            # claim the whole batch in one transaction: a crash mid-claim
            # must not strand a prefix in ADMITTED with no fleet to run it
            # (recover() would fix it, but only after a restart) — RPL030
            with self.store.transaction():
                for row in self.store.list_jobs(states=[CtlState.SUBMITTED]):
                    try:
                        self.store.set_state(
                            row["job_id"],
                            CtlState.ADMITTED,
                            reason="claimed by fleet run",
                        )
                    except InvalidTransition:
                        continue  # cancelled between list and claim
                    spec = spec_from_dict(row["spec"])
                    done = int(row["iterations_done"])
                    if done > 0:
                        # a requeued job already "arrived" in an earlier life;
                        # its original arrival offset must not delay the resume
                        spec.arrival_time = 0.0
                    batch.append((spec, done))
            self._active = {spec.job_id for spec, _ in batch}
            self._terminal_committed = set()
        return batch

    def _build_engine(self) -> Cluster:
        return Cluster(
            self.n_devices,
            self.capacity,
            self.policy,
            strategy=self.strategy,
            memory=MemoryConfig(
                paging=self.paging, page_bandwidth=self.page_bandwidth
            ),
            rebalancer=Rebalancer(mode=self.rebalance_mode),
            # the on_epoch commit cadence is an event-core EpochSchedule:
            # the same kernel that orders the simulators' events produces
            # the boundaries this daemon persists at
            rebalance_interval=EpochSchedule(self.epoch),
            on_epoch=self._on_epoch,
        )

    def _run_fleet(self, batch: List[Tuple[JobSpec, int]]) -> ClusterResult:
        engine = self._build_engine()
        self._off_placement = 0
        self._off_devices = [0] * self.n_devices
        for spec, _ in batch:
            engine.submit(spec)
        resume = {spec.job_id: done for spec, done in batch if done > 0}
        try:
            res = engine.run(resume_done=resume or None)
        except InjectedFailure:
            raise  # models a hard crash: no cleanup; recover() handles it
        except BaseException:
            self._requeue_active("fleet run aborted")
            raise
        self._commit_final(batch, res)
        self._fleet_runs += 1
        with self._ctl_lock:
            self._active = set()
            # leftover pendings: the job finished before the next boundary
            self._pending_cancel -= self._terminal_committed
            self._pending_pause -= self._terminal_committed
        return res

    def _requeue_active(self, reason: str) -> None:
        with self._ctl_lock:
            # all-or-nothing requeue of the aborted fleet's jobs (RPL030)
            with self.store.transaction():
                for jid in sorted(self._active):
                    row = self.store.get_job(jid)
                    if row is not None and row["state"] in _ACTIVE_STATES:
                        try:
                            self.store.set_state(jid, CtlState.SUBMITTED, reason=reason)
                        except InvalidTransition:
                            pass
            self._active = set()

    # ------------------------------------------------------------------
    # Epoch persistence (the crash-safety core)
    # ------------------------------------------------------------------

    def _on_epoch(self, snap: EpochSnapshot, control: EpochControl) -> None:
        # 1) apply queued control commands at the quiescent boundary
        with self._ctl_lock:
            cancels = sorted(self._pending_cancel & self._active)
            pauses = sorted((self._pending_pause & self._active) - set(cancels))
            self._pending_cancel -= set(cancels)
            self._pending_pause -= set(pauses)
            # snapshot for the commit below: this thread is the only
            # writer, so the copy stays current for the whole epoch, and
            # reads inside the store transaction need not take the lock
            already_terminal = set(self._terminal_committed)
        cancelled: List[Tuple[int, Any]] = []
        paused: List[Tuple[int, Any]] = []
        terminal_engine = (JobState.FINISHED, JobState.FAILED, JobState.CANCELLED)
        for jid in cancels:
            if snap.states.get(jid) in terminal_engine:
                continue  # raced with completion: completion wins
            _, st = control.cancel(jid)
            cancelled.append((jid, st))
        for jid in pauses:
            if snap.states.get(jid) in terminal_engine:
                continue
            _, st = control.evict(jid)
            paused.append((jid, st))

        # 2) chaos hook: a crash "between epochs" = before this commit
        self._epoch_seq += 1
        if self.fault_injector is not None:
            self.fault_injector.maybe_fail(self._epoch_seq)

        # 3) one atomic commit: decision suffixes + progress + lifecycle.
        #    The control events from step 1 land in the *next* flush (they
        #    were appended after this snapshot was taken).
        delta_placement = snap.placement_log[self._off_placement :]
        delta_devices = [
            log[self._off_devices[i] :] for i, log in enumerate(snap.device_logs)
        ]
        # placement entries are (kind, ordinal, name, device_id); the jobs
        # migrated this epoch get a MIGRATING hop in their lifecycle
        migrated_names = {e[2] for e in delta_placement if e[0] == "migrate"}
        now = time.time()
        # jobs that reach a terminal state in THIS commit. Collected locally
        # and merged into self._terminal_committed only after the transaction
        # commits: a rollback must not leave the in-memory set claiming a
        # terminal write the store never saw (RPL031 keeps the merge under
        # the server lock, where handler threads read it)
        newly_terminal: Set[int] = set()
        with self.store.transaction():
            self.store.append_decisions("placement", delta_placement)
            for i, delta in enumerate(delta_devices):
                self.store.append_decisions(f"device:{i}", delta)
            for jid, done in sorted(snap.progress.items()):
                if jid in already_terminal:
                    continue
                self.store.update_progress(jid, done, now=now)
            for jid, est in sorted(snap.states.items()):
                if jid in already_terminal:
                    continue
                target = ctl_state_of(est, rejected=jid in snap.rejected)
                row = self.store.get_job(jid)
                name = row["name"] if row is not None else None
                if name in migrated_names and target in (
                    CtlState.RUNNING,
                    CtlState.PAGED,
                ):
                    self.store.set_state(
                        jid, CtlState.MIGRATING, reason="rebalance migration", now=now
                    )
                reason = (
                    "rejected in-engine (P + E > capacity)"
                    if jid in snap.rejected
                    else "epoch observation"
                )
                self.store.set_state(jid, target, reason=reason, now=now)
                if is_terminal(target):
                    newly_terminal.add(jid)
            for jid, st in cancelled:
                self.store.update_progress(jid, st.iterations_done, now=now)
                self.store.set_state(
                    jid, CtlState.CANCELLED, reason="cancel at epoch boundary", now=now
                )
                newly_terminal.add(jid)
            for jid, st in paused:
                self.store.update_progress(jid, st.iterations_done, now=now)
                self.store.set_state(
                    jid, CtlState.PAUSED, reason="pause at epoch boundary", now=now
                )
        # offsets advance only after the transaction committed — a rolled
        # back epoch re-flushes the same suffix next time
        self._off_placement = len(snap.placement_log)
        self._off_devices = [len(log) for log in snap.device_logs]
        with self._ctl_lock:
            self._terminal_committed |= newly_terminal
            self._active -= self._terminal_committed
            self._active -= {jid for jid, _ in paused}
        if self.epoch_sleep > 0:
            # wall-clock pacing so external (SIGKILL) chaos tests can land
            # mid-fleet deterministically; virtual fleets otherwise finish
            # in milliseconds of wall time
            time.sleep(self.epoch_sleep)

    def _commit_final(
        self, batch: List[Tuple[JobSpec, int]], res: ClusterResult
    ) -> None:
        """Post-run commit: the decision-log tail past the last epoch
        boundary plus every job's final progress and terminal state."""
        placement_log = res.placement_log()
        device_logs = [list(r.decision_log) for r in res.device_results]
        delta_placement = placement_log[self._off_placement :]
        delta_devices = [
            log[self._off_devices[i] :] for i, log in enumerate(device_logs)
        ]
        stats = res.stats
        now = time.time()
        newly_terminal: Set[int] = set()  # merged under the lock post-commit
        with self._ctl_lock:
            # snapshot: scheduler thread is the sole writer (see _on_epoch)
            already_terminal = set(self._terminal_committed)
        with self.store.transaction():
            self.store.append_decisions("placement", delta_placement)
            for i, delta in enumerate(delta_devices):
                self.store.append_decisions(f"device:{i}", delta)
            for spec, _ in batch:
                jid = spec.job_id
                if jid in already_terminal:
                    continue
                row = self.store.get_job(jid)
                if row is None or row["state"] not in _ACTIVE_STATES:
                    continue  # paused out mid-run (or already terminal)
                st = stats.get(jid)
                if st is None:
                    # not on any device anymore and not paused: requeue
                    self.store.set_state(
                        jid, CtlState.SUBMITTED, reason="fleet run ended incomplete"
                    )
                    continue
                self.store.update_progress(jid, st.iterations_done, now=now)
                if st.rejected:
                    self.store.set_state(
                        jid,
                        CtlState.FAILED,
                        reason="rejected in-engine (P + E > capacity)",
                        now=now,
                    )
                elif st.finish_time is not None:
                    self.store.set_state(
                        jid, CtlState.FINISHED, reason="fleet run completed", now=now
                    )
                else:
                    self.store.set_state(
                        jid,
                        CtlState.SUBMITTED,
                        reason="fleet run ended incomplete",
                        now=now,
                    )
                    continue
                newly_terminal.add(jid)
        self._off_placement = len(placement_log)
        self._off_devices = [len(log) for log in device_logs]
        with self._ctl_lock:
            self._terminal_committed |= newly_terminal

    # ------------------------------------------------------------------
    # Command surface (shared by the socket server and direct callers)
    # ------------------------------------------------------------------

    def handle_request(self, req: Dict[str, Any]) -> Dict[str, Any]:
        cmd = req.get("cmd")
        try:
            handler = getattr(self, f"_cmd_{cmd}", None)
            if handler is None:
                raise CtlError(f"unknown command {cmd!r}")
            return handler(req)
        except Exception as e:  # command errors must not kill the daemon
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def _cmd_ping(self, req: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "ok": True,
            "pid": os.getpid(),
            "counts": self.store.counts(),
            "epochs": self._epoch_seq,
            "fleet_runs": self._fleet_runs,
            "draining": self._draining,
        }

    def _cmd_submit(self, req: Dict[str, Any]) -> Dict[str, Any]:
        if self._draining:
            raise CtlError("daemon is draining: submissions refused")
        spec = dict(req.get("spec") or {})
        for k in ("name", "n_iters", "iter_time", "persistent", "ephemeral"):
            if k not in spec:
                raise CtlError(f"submit spec missing required field {k!r}")
        if "job_id" not in spec or spec["job_id"] is None:
            spec["job_id"] = self.store.next_job_id()
        spec_from_dict(spec)  # validate before persisting
        # add + optional hold in one transaction: a failed hold must not
        # leave the job behind in SUBMITTED, schedulable (RPL030)
        with self.store.transaction():
            job_id = self.store.add_job(spec)
            if req.get("hold"):
                self.store.set_state(job_id, CtlState.PAUSED, reason="submitted --hold")
        self._wake.set()
        return {"ok": True, "job_id": job_id}

    def _job_payload(self, row: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "job_id": row["job_id"],
            "name": row["name"],
            "state": row["state"].value,
            "iterations_done": row["iterations_done"],
            "n_iters": row["n_iters"],
            "submitted_at": row["submitted_at"],
            "updated_at": row["updated_at"],
            "detail": row["detail"],
        }

    def _cmd_status(self, req: Dict[str, Any]) -> Dict[str, Any]:
        jid = req.get("job_id")
        if jid is not None:
            row = self.store.get_job(int(jid))
            if row is None:
                raise CtlError(f"unknown job {jid}")
            payload = self._job_payload(row)
            payload["transitions"] = [
                {"src": src, "dst": dst, "at": at, "reason": reason}
                for (_, src, dst, at, reason) in self.store.transitions(int(jid))
            ]
            return {"ok": True, "job": payload}
        with self._ctl_lock:
            active = sorted(self._active)
        return {
            "ok": True,
            "jobs": [self._job_payload(r) for r in self.store.list_jobs()],
            "counts": self.store.counts(),
            "decisions": self.store.decision_count(),
            "epochs": self._epoch_seq,
            "fleet_runs": self._fleet_runs,
            "active": active,
            "draining": self._draining,
        }

    def _cmd_cancel(self, req: Dict[str, Any]) -> Dict[str, Any]:
        jid = int(req["job_id"])
        with self._ctl_lock:
            row = self.store.get_job(jid)
            if row is None:
                raise CtlError(f"unknown job {jid}")
            st: CtlState = row["state"]
            if is_terminal(st):
                raise CtlError(f"job {jid} is already terminal ({st.value})")
            if jid in self._active:
                # applied at the next quiescent epoch boundary
                self._pending_cancel.add(jid)
                return {"ok": True, "job_id": jid, "pending": True}
            self.store.set_state(jid, CtlState.CANCELLED, reason="cli cancel")
            return {"ok": True, "job_id": jid, "pending": False}

    def _cmd_pause(self, req: Dict[str, Any]) -> Dict[str, Any]:
        jid = int(req["job_id"])
        with self._ctl_lock:
            row = self.store.get_job(jid)
            if row is None:
                raise CtlError(f"unknown job {jid}")
            st: CtlState = row["state"]
            if is_terminal(st):
                raise CtlError(f"job {jid} is already terminal ({st.value})")
            if st is CtlState.PAUSED:
                return {"ok": True, "job_id": jid, "pending": False}
            if jid in self._active:
                self._pending_pause.add(jid)
                return {"ok": True, "job_id": jid, "pending": True}
            self.store.set_state(jid, CtlState.PAUSED, reason="cli pause")
            return {"ok": True, "job_id": jid, "pending": False}

    def _cmd_resume(self, req: Dict[str, Any]) -> Dict[str, Any]:
        jid = int(req["job_id"])
        row = self.store.get_job(jid)
        if row is None:
            raise CtlError(f"unknown job {jid}")
        if row["state"] is not CtlState.PAUSED:
            raise CtlError(
                f"job {jid} is {row['state'].value}, only PAUSED jobs resume"
            )
        self.store.set_state(jid, CtlState.SUBMITTED, reason="cli resume")
        self._wake.set()
        return {"ok": True, "job_id": jid}

    def _quiet(self) -> bool:
        counts = self.store.counts()
        busy = (
            CtlState.SUBMITTED.value,
            CtlState.ADMITTED.value,
            CtlState.RUNNING.value,
            CtlState.PAGED.value,
            CtlState.MIGRATING.value,
        )
        return not any(counts.get(s, 0) for s in busy)

    def _cmd_drain(self, req: Dict[str, Any]) -> Dict[str, Any]:
        self._draining = True
        timeout = float(req.get("timeout", 0.0) or 0.0)
        if req.get("wait"):
            deadline = time.monotonic() + (timeout if timeout > 0 else 60.0)
            while not self._quiet() and time.monotonic() < deadline:
                time.sleep(self.poll_interval)
        return {"ok": True, "draining": True, "quiet": self._quiet()}

    def _cmd_shutdown(self, req: Dict[str, Any]) -> Dict[str, Any]:
        # Under a socket server the handler stops it once this reply is
        # written: a stop started here can end the process first, and the
        # client then reads no reply.
        if self._server is None:
            self.stop()
        return {"ok": True, "stopping": True}

    # ------------------------------------------------------------------
    # Threaded serving (socket mode)
    # ------------------------------------------------------------------

    def _scheduler_loop(self) -> None:
        while not self._stop.is_set():
            try:
                ran = self.run_pending_fleets(max_runs=1)
            except Exception:
                traceback.print_exc()
                ran = 0
            if not ran:
                self._wake.wait(self.poll_interval)
                self._wake.clear()

    def serve(self) -> None:
        """Recover, start the scheduler thread, and serve the socket until
        :meth:`stop` (or a shutdown command). Blocks."""
        self.recover()
        self._sched_thread = threading.Thread(
            target=self._scheduler_loop, name="ctl-scheduler", daemon=True
        )
        self._sched_thread.start()
        if self.socket_path is None:
            self._stop.wait()
            return
        daemon = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                for line in self.rfile:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        req = json.loads(line)
                    except ValueError as e:
                        resp = {"ok": False, "error": f"bad request: {e}"}
                    else:
                        resp = daemon.handle_request(req)
                    self.wfile.write(json.dumps(resp).encode() + b"\n")
                    self.wfile.flush()
                    if resp.get("stopping"):
                        daemon.stop()
                        return

        class Server(socketserver.ThreadingMixIn, socketserver.UnixStreamServer):
            daemon_threads = True
            allow_reuse_address = True

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)  # stale socket from a dead process
        self._server = Server(self.socket_path, Handler)
        try:
            self._server.serve_forever(poll_interval=self.poll_interval)
        finally:
            self._server.server_close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._server is not None:
            self._server.shutdown()


class CtlClient:
    """Tiny blocking client for the daemon's unix-socket JSON protocol."""

    def __init__(self, socket_path: str, timeout: float = 30.0) -> None:
        self.socket_path = socket_path
        self.timeout = timeout

    def request(self, cmd: str, **kw: Any) -> Dict[str, Any]:
        req = {"cmd": cmd, **kw}
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
            s.settimeout(self.timeout)
            s.connect(self.socket_path)
            s.sendall(json.dumps(req).encode() + b"\n")
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        resp = json.loads(buf.decode())
        if not resp.get("ok"):
            raise CtlError(resp.get("error", "request failed"))
        return resp

    def wait_quiet(self, timeout: float = 30.0, poll: float = 0.05) -> Dict[str, Any]:
        """Poll status until no job is schedulable (all terminal or
        PAUSED); returns the final status payload."""
        busy = {"submitted", "admitted", "running", "paged", "migrating"}
        deadline = time.monotonic() + timeout
        while True:
            st = self.request("status")
            if not any(st["counts"].get(s, 0) for s in busy):
                return st
            if time.monotonic() > deadline:
                raise TimeoutError(f"jobs still active after {timeout}s: {st['counts']}")
            time.sleep(poll)
