"""The port's control-plane daemon (``repro_torch.ctl.daemon``, ``cli``)
against the JAX package's ``repro.ctl`` on the CPU.

* Twins of ``tests/test_ctl_daemon.py`` and ``tests/test_ctl_recovery.py``
  run against ``repro_torch.ctl``: fleet runs over the store, commands at
  epoch boundaries, the socket protocol, injected crashes under
  ``RestartSupervisor`` and a SIGKILL of ``python -m repro_torch.ctl``.
* Same rows: a seeded ``cluster_trace`` submitted to both daemons ends in
  identical stores (``jobs`` without its timestamps, ``transitions``
  without ``at``, ``decisions`` with each entry's JSON text, ``meta``),
  paging off and on, rebalance ``none`` and ``consolidate``, 1 and 3
  devices.
* Same kills: ``FailureInjector`` fires at the same epoch commit points in
  both packages, and the stores are identical after every kill and at the
  end.
* Cross-read: a store one package crashed mid-fleet is recovered by the
  other and ends identical to the writer recovering a copy of it.
* The daemon's process imports no torch (nor JAX).

Every wait polls against a deadline and every subprocess has a timeout.
"""
import dataclasses
import os
import signal
import sqlite3
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import repro.core.tracegen as jax_tracegen  # noqa: E402
import repro.ctl as jax_ctl  # noqa: E402
import repro.dist.fault as jax_fault  # noqa: E402
import repro_torch.ctl as port_ctl  # noqa: E402
import repro_torch.dist.fault as port_fault  # noqa: E402
from repro_torch.core.types import GB, MB  # noqa: E402
from repro_torch.ctl import CtlClient, CtlDaemon, CtlError, CtlState, JobStore  # noqa: E402
from repro_torch.ctl.cli import main as ctl_main  # noqa: E402
from repro_torch.dist.fault import (  # noqa: E402
    FailureInjector,
    InjectedFailure,
    RestartSupervisor,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": (jax_ctl, jax_fault), "port": (port_ctl, port_fault)}


def _spec(name="j", n_iters=20, **kw):
    d = {
        "name": name,
        "n_iters": n_iters,
        "iter_time": 1.0,
        "persistent": 200 * MB,
        "ephemeral": 800 * MB,
    }
    d.update(kw)
    return d


def _submit(daemon, name="j", n_iters=20, hold=False, **kw):
    resp = daemon.handle_request(
        {"cmd": "submit", "spec": _spec(name, n_iters, **kw), "hold": hold})
    assert resp["ok"], resp
    return resp["job_id"]


def _poll(cond, timeout, what):
    deadline = time.monotonic() + timeout
    while True:
        out = cond()
        if out:
            return out
        assert time.monotonic() < deadline, f"{what} not within {timeout} s"
        time.sleep(0.02)


def rows(path):
    """Everything a store holds but its wall-clock stamps: ``jobs``
    without ``submitted_at``/``updated_at``, ``transitions`` without
    ``at``, ``decisions`` with the entry's JSON text, and ``meta``."""
    conn = sqlite3.connect(path)
    try:
        return {
            "jobs": conn.execute(
                "SELECT job_id, name, spec, state, iterations_done, n_iters, detail"
                " FROM jobs ORDER BY job_id").fetchall(),
            "transitions": conn.execute(
                "SELECT seq, job_id, src, dst, reason FROM transitions ORDER BY seq").fetchall(),
            "decisions": conn.execute(
                "SELECT seq, source, entry FROM decisions ORDER BY seq").fetchall(),
            "meta": conn.execute("SELECT key, value FROM meta ORDER BY key").fetchall(),
        }
    finally:
        conn.close()


def copy_store(src, dst):
    """A consistent copy of a live store (sqlite's backup API, WAL read)."""
    a, b = sqlite3.connect(src), sqlite3.connect(dst)
    try:
        a.backup(b)
    finally:
        a.close()
        b.close()


# ---------------------------------------------------------------------------
# same rows, same kills, cross-read: the port's daemon against JAX's
# ---------------------------------------------------------------------------


# at 14 GB a device the one-device trace pages a job out and back, and the
# three-device trace migrates one under ``consolidate``
TRACE_FLEET = dict(capacity=14 * GB, policy="srtf", page_bandwidth=1e12, epoch=50.0)


def _trace_specs(n_devices, seed):
    """A seeded ``cluster_trace`` as submission dicts, iterations capped so
    that a fleet run takes milliseconds (``tests/test_torch_cluster.py``)."""
    jobs = [dataclasses.replace(j, n_iters=min(j.n_iters, 200))
            for j in jax_tracegen.cluster_trace(n_devices, jobs_per_device=6, seed=seed)]
    specs = []
    for j in jobs:
        d = jax_ctl.spec_to_dict(j)
        del d["job_id"]  # the store allocates ids
        specs.append(d)
    return specs


def _daemon(pkg, path, injector=None, **kw):
    ctl, fault = PKGS[pkg]
    return ctl.CtlDaemon(
        path, fault_injector=None if injector is None else fault.FailureInjector(injector),
        **kw)


@pytest.mark.parametrize("n_devices", [1, 3], ids=["1dev", "3dev"])
@pytest.mark.parametrize("rebalance", ["none", "consolidate"])
@pytest.mark.parametrize("paging", [False, True], ids=["paging-off", "paging-on"])
def test_same_rows_as_jax(tmp_path, paging, rebalance, n_devices):
    specs = _trace_specs(n_devices, seed=n_devices)
    kw = dict(TRACE_FLEET, n_devices=n_devices, paging=paging, rebalance_mode=rebalance)
    out = {}
    for pkg in PKGS:
        path = str(tmp_path / f"{pkg}.sqlite")
        d = _daemon(pkg, path, **kw)
        for s in specs:
            assert d.handle_request({"cmd": "submit", "spec": s})["ok"]
        assert d.run_pending_fleets() == 1
        d.store.replay()
        d.store.close()
        out[pkg] = rows(path)
    assert out["port"] == out["jax"]
    assert {r[3] for r in out["port"]["jobs"]} == {"finished"}
    assert out["port"]["decisions"]
    if n_devices == 3 and rebalance == "consolidate":
        assert any('"migrate"' in r[2] for r in out["port"]["decisions"])
        assert any(r[3] == "migrating" for r in out["port"]["transitions"])
    if paging and n_devices == 1:
        assert any('"page_out"' in r[2] for r in out["port"]["decisions"])
        assert any(r[3] == "paged" for r in out["port"]["transitions"])


KILL_CASES = {
    # tests/test_ctl_recovery.py's two fleets, and a consolidating one
    "paging-off": dict(n=3, sizes=(200 * MB, 800 * MB), n_iters=40,
                       kw=dict(n_devices=2, capacity=4 * GB, epoch=10.0)),
    "paging-on": dict(n=3, sizes=(700 * MB, 900 * MB), n_iters=40,
                      kw=dict(n_devices=1, capacity=2 * GB, epoch=10.0, paging=True)),
    "consolidate": dict(trace=3, kw=dict(TRACE_FLEET, n_devices=3, rebalance_mode="consolidate")),
}


def _seed_store(pkg, path, case):
    s = PKGS[pkg][0].JobStore(path)
    if "trace" in case:
        specs = _trace_specs(case["trace"], seed=case["trace"])
    else:
        specs = [_spec(f"c{i}", case["n_iters"], persistent=case["sizes"][0],
                       ephemeral=case["sizes"][1]) for i in range(case["n"])]
    for spec in specs:
        s.add_job(dict(spec, job_id=s.next_job_id()))
    return s


@pytest.mark.parametrize("case", list(KILL_CASES))
def test_same_kills_as_jax(tmp_path, case):
    """Both packages crash at epoch commits 2 and 5 under
    ``RestartSupervisor``; after every kill, and at the end, the stores are
    identical and each log extends the one before the kill."""
    c = KILL_CASES[case]
    stores, injectors, sups, lives = {}, {}, {}, {}
    for pkg, (ctl, fault) in PKGS.items():
        stores[pkg] = _seed_store(pkg, str(tmp_path / f"{pkg}.sqlite"), c)
        injectors[pkg] = fault.FailureInjector(steps=[2, 5])
        sups[pkg] = fault.RestartSupervisor(max_restarts=5)
        lives[pkg] = []

    def body(pkg):
        ctl, fault = PKGS[pkg]

        def run(start):
            store = stores[pkg]
            daemon = ctl.CtlDaemon(store, fault_injector=injectors[pkg], **c["kw"])
            daemon.recover()
            try:
                daemon.run_pending_fleets()
            except fault.InjectedFailure:
                lives[pkg].append((rows(store.path), store.decision_log()))
                raise
            return 0
        return run

    for pkg in PKGS:
        sups[pkg].run(body(pkg), resume_step=lambda: 0)
        assert sups[pkg].restarts == 2
    assert len(lives["port"]) == len(lives["jax"]) == 2
    for (port_rows, _), (jax_rows, _) in zip(lives["port"], lives["jax"]):
        assert port_rows == jax_rows
    final = stores["port"].decision_log()
    for _, log in lives["port"]:
        assert final[: len(log)] == log
    assert rows(stores["port"].path) == rows(stores["jax"].path)
    n_iters = {r["job_id"]: r["n_iters"] for r in stores["port"].list_jobs()}
    for jid in n_iters:
        row = stores["port"].get_job(jid)
        assert row["state"] is CtlState.FINISHED and row["iterations_done"] == n_iters[jid]
    assert "crash-recovery requeue" in [t[4] for t in stores["port"].transitions()]
    for s in stores.values():
        s.replay()
        s.close()


@pytest.mark.parametrize("case", ["paging-off", "consolidate"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_crashed_by_one_recovered_by_other(tmp_path, writer, case):
    """``writer``'s daemon crashes at its third epoch commit; the other
    package recovers one copy of the store and ``writer`` another, and
    both end identical, every job finished once."""
    c = KILL_CASES[case]
    reader = "port" if writer == "jax" else "jax"
    crashed = str(tmp_path / "crashed.sqlite")
    store = _seed_store(writer, crashed, c)
    d = _daemon(writer, store, injector=[3], **c["kw"])
    with pytest.raises(PKGS[writer][1].InjectedFailure):
        d.run_pending_fleets()
    at_crash = rows(crashed)
    assert any(r[4] > 0 for r in at_crash["jobs"])
    assert any(r[3] != "finished" for r in at_crash["jobs"])
    ends = {}
    for pkg in (reader, writer):
        path = str(tmp_path / f"{pkg}.sqlite")
        copy_store(crashed, path)
        daemon = _daemon(pkg, path, **c["kw"])
        requeued = daemon.recover()
        assert requeued
        assert daemon.run_pending_fleets() == 1
        daemon.store.replay()
        daemon.store.close()
        ends[pkg] = rows(path)
    store.close()
    assert ends[reader] == ends[writer]
    end = ends[reader]
    assert {r[3] for r in end["jobs"]} == {"finished"}
    assert all(r[4] == r[5] for r in end["jobs"])
    assert end["decisions"][: len(at_crash["decisions"])] == at_crash["decisions"]
    for jid in {r[0] for r in end["jobs"]}:
        assert sum(1 for t in end["transitions"] if t[1] == jid and t[3] == "finished") == 1


# ---------------------------------------------------------------------------
# twins of tests/test_ctl_daemon.py
# ---------------------------------------------------------------------------


@pytest.fixture
def daemon(tmp_path):
    d = CtlDaemon(str(tmp_path / "jobs.sqlite"), epoch=10.0, n_devices=2, capacity=4 * GB,
                  policy="fifo")
    yield d
    d.store.close()


def test_submit_run_finish(daemon):
    ids = [_submit(daemon, f"job{i}", 20 + 5 * i) for i in range(3)]
    assert daemon.run_pending_fleets() == 1
    for jid in ids:
        row = daemon.store.get_job(jid)
        assert row["state"] is CtlState.FINISHED
        assert row["iterations_done"] == row["n_iters"]
    assert daemon.store.decision_count() > 0
    assert "placement" in daemon.store.decision_sources()
    daemon.store.replay()


def test_status_agrees_with_store(daemon):
    ids = [_submit(daemon, f"job{i}") for i in range(2)]
    daemon.run_pending_fleets()
    status = daemon.handle_request({"cmd": "status"})
    assert status["ok"]
    by_id = {j["job_id"]: j for j in status["jobs"]}
    for row in daemon.store.list_jobs():
        j = by_id[row["job_id"]]
        assert j["state"] == row["state"].value
        assert j["iterations_done"] == row["iterations_done"]
    assert status["counts"] == daemon.store.counts()
    one = daemon.handle_request({"cmd": "status", "job_id": ids[0]})
    assert [t["dst"] for t in one["job"]["transitions"]] == [
        "submitted", "admitted", "running", "finished"]


def test_run_with_empty_store_is_a_noop(daemon):
    assert daemon.run_pending_fleets() == 0


def test_duplicate_job_id_refused_at_daemon(daemon):
    spec = _spec("dup")
    spec["job_id"] = 7
    assert daemon.handle_request({"cmd": "submit", "spec": spec})["ok"]
    r2 = daemon.handle_request({"cmd": "submit", "spec": spec})
    assert not r2["ok"] and "duplicate" in r2["error"]


def test_hold_then_resume(daemon):
    jid = _submit(daemon, "held", hold=True)
    assert daemon.run_pending_fleets() == 0
    assert daemon.store.get_job(jid)["state"] is CtlState.PAUSED
    assert daemon.handle_request({"cmd": "resume", "job_id": jid})["ok"]
    daemon.run_pending_fleets()
    assert daemon.store.get_job(jid)["state"] is CtlState.FINISHED


def test_cancel_idle_job_is_immediate(daemon):
    jid = _submit(daemon, "victim")
    resp = daemon.handle_request({"cmd": "cancel", "job_id": jid})
    assert resp["ok"] and resp["pending"] is False
    assert daemon.store.get_job(jid)["state"] is CtlState.CANCELLED
    assert daemon.run_pending_fleets() == 0
    assert not daemon.handle_request({"cmd": "cancel", "job_id": jid})["ok"]


def test_all_jobs_cancelled_leaves_defined_empty_surfaces(daemon):
    for i in range(3):
        jid = _submit(daemon, f"c{i}")
        daemon.handle_request({"cmd": "cancel", "job_id": jid})
    assert daemon.run_pending_fleets() == 0
    assert daemon.store.counts() == {"cancelled": 3}
    status = daemon.handle_request({"cmd": "status"})
    assert status["ok"] and status["decisions"] == 0


def test_unknown_command_and_bad_specs(daemon):
    assert not daemon.handle_request({"cmd": "frobnicate"})["ok"]
    assert not daemon.handle_request({"cmd": "submit", "spec": {"name": "x"}})["ok"]
    assert not daemon.handle_request({"cmd": "cancel", "job_id": 999})["ok"]
    assert not daemon.handle_request({"cmd": "resume", "job_id": 999})["ok"]


def test_recover_finishes_job_whose_last_commit_was_complete(tmp_path):
    store = JobStore(str(tmp_path / "jobs.sqlite"))
    spec = _spec("done", n_iters=4)
    spec["job_id"] = store.next_job_id()
    jid = store.add_job(spec)
    store.set_state(jid, CtlState.ADMITTED)
    store.update_progress(jid, 4)
    d = CtlDaemon(store, epoch=10.0)
    assert d.recover() == []
    assert store.get_job(jid)["state"] is CtlState.FINISHED
    store.close()


@pytest.fixture
def served(tmp_path):
    sock = str(tmp_path / "ctl.sock")
    daemon = CtlDaemon(str(tmp_path / "jobs.sqlite"), socket_path=sock, epoch=5.0,
                       epoch_sleep=0.02, n_devices=1, capacity=4 * GB, policy="fifo")
    thread = threading.Thread(target=daemon.serve, daemon=True)
    thread.start()
    _poll(lambda: os.path.exists(sock), 10.0, "the daemon's socket")
    yield CtlClient(sock), daemon
    daemon.stop()
    thread.join(timeout=10.0)
    daemon.store.close()


def _running(client, jid):
    """The job is owned by the live fleet run and has committed an epoch."""
    st = client.request("status")
    row = next(j for j in st["jobs"] if j["job_id"] == jid)
    return jid in st["active"] and row["iterations_done"] > 0


def test_socket_submit_status_cancel(served):
    client, daemon = served
    assert client.request("ping")["pid"] == os.getpid()
    long = client.request("submit", spec=_spec("long", n_iters=500))["job_id"]
    short = client.request("submit", spec=_spec("short", n_iters=30))["job_id"]
    _poll(lambda: _running(client, long), 30.0, "the long job running")
    resp = client.request("cancel", job_id=long)
    assert resp["ok"] and resp["pending"] is True  # applied at the next boundary
    status = client.wait_quiet(timeout=60.0)
    by_id = {j["job_id"]: j for j in status["jobs"]}
    assert by_id[long]["state"] == "cancelled"
    assert 0 < by_id[long]["iterations_done"] < 500
    assert by_id[short]["state"] == "finished"
    assert by_id[short]["iterations_done"] == 30
    for row in daemon.store.list_jobs():
        assert by_id[row["job_id"]]["state"] == row["state"].value


def test_socket_pause_keeps_progress_and_resumes(served):
    client, daemon = served
    jid = client.request("submit", spec=_spec("pauseme", n_iters=400))["job_id"]
    _poll(lambda: _running(client, jid), 30.0, "the job running")
    client.request("pause", job_id=jid)
    row = _poll(lambda: (lambda r: r if r["state"] == "paused" else None)(
        client.request("status", job_id=jid)["job"]), 30.0, "the pause")
    paused_at = row["iterations_done"]
    assert 0 < paused_at < 400
    client.request("resume", job_id=jid)
    client.wait_quiet(timeout=60.0)
    row = client.request("status", job_id=jid)["job"]
    assert row["state"] == "finished" and row["iterations_done"] == 400
    dsts = [t["dst"] for t in row["transitions"]]
    assert dsts.count("paused") == 1 and dsts.count("finished") == 1


def test_socket_drain_refuses_submissions(served):
    client, daemon = served
    jid = client.request("submit", spec=_spec("last", n_iters=20))["job_id"]
    resp = client.request("drain", wait=True, timeout=30.0)
    assert resp["draining"] and resp["quiet"]
    with pytest.raises(CtlError):
        client.request("submit", spec=_spec("toolate"))
    assert daemon.store.get_job(jid)["state"] is CtlState.FINISHED


# ---------------------------------------------------------------------------
# twins of tests/test_ctl_recovery.py
# ---------------------------------------------------------------------------


def _add(store, name, n_iters, persistent, ephemeral):
    return store.add_job(dict(_spec(name, n_iters, persistent=persistent, ephemeral=ephemeral),
                              job_id=store.next_job_id()))


def _assert_no_loss_no_double_run(store, ids, n_iters):
    for jid in ids:
        row = store.get_job(jid)
        assert row["state"] is CtlState.FINISHED, (jid, row["state"])
        assert row["iterations_done"] == n_iters
        history = store.transitions(jid)
        assert sum(1 for t in history if t[2] == "finished") == 1, history
    assert "crash-recovery requeue" in [t[4] for t in store.transitions()]
    store.replay()


@pytest.mark.parametrize("paging", [False, True], ids=["paging-off", "paging-on"])
def test_injected_crash_between_epochs_recovers(tmp_path, paging):
    store = JobStore(str(tmp_path / "jobs.sqlite"))
    if paging:
        cap, n_dev, sizes = int(2 * GB), 1, (700 * MB, 900 * MB)
    else:
        cap, n_dev, sizes = int(4 * GB), 2, (200 * MB, 800 * MB)
    n_iters = 40
    ids = [_add(store, f"c{i}", n_iters, *sizes) for i in range(3)]
    injector = FailureInjector(steps=[2, 5])
    supervisor = RestartSupervisor(max_restarts=5)
    committed = {"log": []}

    def body(start):
        log = store.decision_log()
        assert log[: len(committed["log"])] == committed["log"]
        committed["log"] = log
        daemon = CtlDaemon(store, epoch=10.0, n_devices=n_dev, capacity=cap, policy="fifo",
                           paging=paging, fault_injector=injector)
        daemon.recover()
        try:
            daemon.run_pending_fleets()
        except InjectedFailure:
            committed["log"] = store.decision_log()
            raise
        return 0

    supervisor.run(body, resume_step=lambda: 0)
    assert supervisor.restarts == 2
    assert store.decision_log()[: len(committed["log"])] == committed["log"]
    _assert_no_loss_no_double_run(store, ids, n_iters)
    if paging:
        kinds = {e[0] for e in store.decision_log()}
        assert "page_out" in kinds and "page_in" in kinds
    store.close()


def test_progress_survives_crash_and_is_not_rerun(tmp_path):
    store = JobStore(str(tmp_path / "jobs.sqlite"))
    jid = _add(store, "solo", 60, 200 * MB, 800 * MB)
    daemon = CtlDaemon(store, epoch=10.0, n_devices=1, capacity=4 * GB, policy="fifo",
                       fault_injector=FailureInjector(steps=[3]))
    with pytest.raises(InjectedFailure):
        daemon.run_pending_fleets()
    mid = store.get_job(jid)["iterations_done"]
    assert 0 < mid < 60
    d2 = CtlDaemon(store, epoch=10.0, n_devices=1, capacity=4 * GB, policy="fifo")
    assert d2.recover() == [jid]
    d2.run_pending_fleets()
    row = store.get_job(jid)
    assert row["state"] is CtlState.FINISHED and row["iterations_done"] == 60
    store.close()


def test_daemon_process_imports_no_torch():
    """The control plane runs the simulated fleet: ``python -m
    repro_torch.ctl`` loads neither torch nor JAX, which keeps a daemon's
    start under a second (the card's ctl phase starts two)."""
    code = ("import sys, repro_torch.ctl, repro_torch.ctl.cli\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'torch', 'jax', 'repro'}))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, env={"PYTHONPATH": os.path.join(REPO, "src"),
                                           "PATH": os.environ.get("PATH", "")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


def _start_daemon(tmp_path, store, sock, epoch_sleep):
    if os.path.exists(sock):
        os.unlink(sock)  # stale socket left behind by a SIGKILLed daemon
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.ctl", "--socket", sock, "start",
         "--store", store, "--capacity-gb", "4.0", "--epoch", "20",
         "--epoch-sleep", str(epoch_sleep)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, cwd=str(tmp_path),
    )
    deadline = time.monotonic() + 60.0
    while not os.path.exists(sock):
        if proc.poll() is not None:
            raise AssertionError(proc.communicate(timeout=10.0)[0].decode())
        if time.monotonic() > deadline:
            proc.kill()
            proc.wait(timeout=10.0)
            raise AssertionError("daemon socket never appeared")
        time.sleep(0.05)
    return proc


def test_shutdown_reply_survives_a_slow_handler(tmp_path):
    """``shutdown`` is answered before the server stops: with the handler
    thread slow between the command and its reply, the client still reads
    ``stopping`` rather than a connection the exiting process dropped."""
    sock, store = str(tmp_path / "s"), str(tmp_path / "jobs.sqlite")
    code = (
        "import sys, time\n"
        "from repro_torch.ctl import daemon\n"
        "real = daemon.CtlDaemon.handle_request\n"
        "def slow(self, req):\n"
        "    resp = real(self, req)\n"
        "    if req.get('cmd') == 'shutdown':\n"
        "        time.sleep(0.5)\n"
        "    return resp\n"
        "daemon.CtlDaemon.handle_request = slow\n"
        "from repro_torch.ctl.cli import main\n"
        f"sys.exit(main(['--socket', {sock!r}, 'start', '--store', {store!r}]))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=str(tmp_path),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        _poll(lambda: os.path.exists(sock) or proc.poll() is not None, 60.0, "daemon socket")
        assert proc.poll() is None, proc.communicate(timeout=10)[0].decode()
        assert CtlClient(sock).request("shutdown") == {"ok": True, "stopping": True}
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def test_sigkill_daemon_mid_fleet_recovers(tmp_path):
    """``python -m repro_torch.ctl`` is SIGKILLed after its first committed
    epoch; a second daemon on the same store recovers, finishes every job
    once, and ``status`` agrees with the store."""
    store_path = str(tmp_path / "jobs.sqlite")
    sock = str(tmp_path / "ctl.sock")
    procs = [_start_daemon(tmp_path, store_path, sock, epoch_sleep=0.05)]
    try:
        client = CtlClient(sock)
        for i in range(3):
            assert ctl_main([
                "--socket", sock, "submit", "--name", f"t{i}", "--iters", "300",
                "--iter-time", "1.0", "--persistent-mb", "200", "--ephemeral-mb", "800",
            ]) == 0
        reader = JobStore(store_path)
        _poll(lambda: any(r["iterations_done"] > 0 for r in reader.list_jobs())
              and reader.decision_count() > 0, 30.0, "a committed epoch")
        os.kill(procs[0].pid, signal.SIGKILL)
        procs[0].wait(timeout=10.0)
        pre_log = reader.decision_log()
        pre_rows = {r["job_id"]: (r["state"], r["iterations_done"]) for r in reader.list_jobs()}
        assert any(st is not CtlState.FINISHED for st, _ in pre_rows.values())

        procs.append(_start_daemon(tmp_path, store_path, sock, epoch_sleep=0.0))
        client.wait_quiet(timeout=120.0)
        post_log = reader.decision_log()
        assert post_log[: len(pre_log)] == pre_log
        assert len(post_log) > len(pre_log)
        _assert_no_loss_no_double_run(reader, list(pre_rows), 300)
        status = client.request("status")
        by_id = {j["job_id"]: j for j in status["jobs"]}
        for row in reader.list_jobs():
            assert by_id[row["job_id"]]["state"] == row["state"].value
            assert by_id[row["job_id"]]["iterations_done"] == row["iterations_done"]
        assert ctl_main(["--socket", sock, "shutdown"]) == 0
        procs[1].wait(timeout=30.0)
        reader.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10.0)
