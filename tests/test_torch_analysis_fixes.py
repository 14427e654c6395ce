"""Twins of ``tests/test_analysis_fixes.py`` against the port: the fixes
the linter forced on the JAX tree hold in ``repro_torch`` too.

- RPL003: ``repro_torch.core.types.JobSpec.__hash__`` is the job id, not
  builtin ``hash()``, so two processes agree on it whatever their
  ``PYTHONHASHSEED``.
- RPL030: ``repro_torch.ctl.CtlDaemon``'s ``submit --hold`` writes the job
  and its hold in one transaction, and ``recover()`` requeues the dead
  fleet in one: all or nothing.
"""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

from repro_torch.core.types import GB, MB, JobSpec, MemoryProfile  # noqa: E402
from repro_torch.ctl import CtlDaemon, CtlState  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


@pytest.fixture
def daemon(tmp_path):
    d = CtlDaemon(
        str(tmp_path / "jobs.sqlite"),
        epoch=10.0,
        n_devices=2,
        capacity=4 * GB,
        policy="fifo",
    )
    yield d
    d.store.close()


# ----------------------------------------------------------------------
# RPL003: JobSpec hashing must not go through builtin hash()
# ----------------------------------------------------------------------


def test_jobspec_hash_is_the_job_id():
    spec = JobSpec("a", MemoryProfile(1 * MB, 2 * MB), 10, 1.0)
    spec.job_id = 7  # ids are auto-assigned; pin for the assertion
    assert hash(spec) == 7
    twin = JobSpec("other-name", MemoryProfile(9 * MB, 9 * MB), 99, 2.0)
    twin.job_id = 7
    assert hash(twin) == hash(spec)
    assert twin == spec  # identity is the id, nothing else


def test_jobspec_hash_stable_across_hash_seeds():
    prog = (
        "from repro_torch.core.types import JobSpec, MemoryProfile, MB;"
        "s = JobSpec('j', MemoryProfile(MB, MB), 5, 1.0);"
        "s.job_id = 42;"
        "print(hash(s))"
    )
    outs = set()
    for seed in ("1", "31337"):
        r = subprocess.run(
            [sys.executable, "-c", prog],
            capture_output=True,
            text=True,
            timeout=60,
            env={"PYTHONPATH": os.path.join(REPO, "src"), "PYTHONHASHSEED": seed,
                 "PATH": os.environ.get("PATH", "")},
        )
        assert r.returncode == 0, r.stderr
        outs.add(r.stdout.strip())
    assert outs == {"42"}


# ----------------------------------------------------------------------
# RPL030: submit --hold is atomic
# ----------------------------------------------------------------------


def test_submit_hold_rolls_back_if_hold_fails(daemon, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("injected hold failure")

    monkeypatch.setattr(daemon.store, "set_state", boom)
    resp = daemon.handle_request(
        {"cmd": "submit", "spec": _spec("held"), "hold": True}
    )
    assert not resp["ok"]
    assert "injected hold failure" in resp["error"]
    # a two-commit submit would leave the job SUBMITTED (schedulable) here
    assert daemon.store.list_jobs() == []

    monkeypatch.undo()
    resp = daemon.handle_request(
        {"cmd": "submit", "spec": _spec("held"), "hold": True}
    )
    assert resp["ok"]
    assert daemon.store.get_job(resp["job_id"])["state"] is CtlState.PAUSED


# ----------------------------------------------------------------------
# RPL030: crash-recovery requeue is all-or-nothing
# ----------------------------------------------------------------------


def test_recover_requeues_all_or_nothing(daemon, monkeypatch):
    jids = []
    for i in range(2):
        resp = daemon.handle_request({"cmd": "submit", "spec": _spec(f"j{i}")})
        assert resp["ok"]
        jids.append(resp["job_id"])
    # simulate a dead fleet run that owned both jobs
    for jid in jids:
        daemon.store.set_state(jid, CtlState.ADMITTED)
        daemon.store.set_state(jid, CtlState.RUNNING)

    real_set_state = daemon.store.set_state
    calls = {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected mid-recovery crash")
        return real_set_state(*a, **kw)

    monkeypatch.setattr(daemon.store, "set_state", flaky)
    with pytest.raises(RuntimeError, match="mid-recovery"):
        daemon.recover()
    monkeypatch.undo()

    # the first requeue write rolled back with the failed one: nothing
    # moved, so a retry sees the identical dead-fleet picture
    states = {row["job_id"]: row["state"] for row in daemon.store.list_jobs()}
    assert states == {jid: CtlState.RUNNING for jid in jids}

    assert sorted(daemon.recover()) == sorted(jids)
    states = {row["job_id"]: row["state"] for row in daemon.store.list_jobs()}
    assert states == {jid: CtlState.SUBMITTED for jid in jids}
