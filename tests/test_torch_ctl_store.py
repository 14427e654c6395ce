"""The port's control plane, its lifecycle table and job store
(``repro_torch.ctl.state_machine``, ``repro_torch.ctl.store``), against
the JAX package's ``repro.ctl`` on the CPU.

* Twins of ``tests/test_ctl_state_machine.py`` and
  ``tests/test_ctl_store.py``, run against ``repro_torch.ctl``.
* The lifecycle tables of both packages are equal by member names:
  ``CtlState``, ``TRANSITIONS``, ``TERMINAL``, the engine projection.
* The schema is one: both stores' ``sqlite_master`` rows are equal, WAL
  journaling included, and a spec's stored form is the same text.
* A store one package writes, the other reads: jobs, history, decisions
  and meta, and its ``replay()`` gives the same states.
* ``chip_smoke.py``'s ctl phase (``phase_ctl``) on the CPU: two daemons of
  ``python -m repro_torch.ctl``, the first SIGKILLed, the second recovering.
"""
import json
import sqlite3

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import chip_smoke  # noqa: E402
import repro.core.types as jax_types  # noqa: E402
import repro.ctl.state_machine as jax_sm  # noqa: E402
import repro.ctl.store as jax_store  # noqa: E402
import repro_torch.ctl.state_machine as port_sm  # noqa: E402
import repro_torch.ctl.store as port_store  # noqa: E402
from repro_torch.core.placement import PlacementEventKind  # noqa: E402
from repro_torch.core.types import MB, JobSpec, JobState, MemoryEventKind, MemoryProfile  # noqa: E402
from repro_torch.ctl.state_machine import (  # noqa: E402
    TERMINAL,
    TRANSITIONS,
    CtlState,
    InvalidTransition,
    can_transition,
    ctl_state_of,
    is_terminal,
    validate_transition,
)
from repro_torch.ctl.store import (  # noqa: E402
    DuplicateJob,
    JobStore,
    StoreCorruption,
    spec_from_dict,
    spec_to_dict,
)

STORES = {"jax": jax_store, "port": port_store}


def _names(states):
    return sorted(s.name for s in states)


# ---------------------------------------------------------------------------
# twins of tests/test_ctl_state_machine.py
# ---------------------------------------------------------------------------


def test_every_state_has_a_transition_row():
    assert set(TRANSITIONS) == set(CtlState)


def test_terminal_states_are_absorbing():
    for t in TERMINAL:
        assert is_terminal(t)
        assert TRANSITIONS[t] == frozenset()
        for dst in CtlState:
            if dst is not t:
                with pytest.raises(InvalidTransition):
                    validate_transition(t, dst)


def test_nominal_forward_path_is_legal():
    path = [CtlState.SUBMITTED, CtlState.ADMITTED, CtlState.RUNNING, CtlState.FINISHED]
    for src, dst in zip(path, path[1:]):
        validate_transition(src, dst)


def test_cancel_reaches_every_nonterminal_state():
    for s in CtlState:
        if is_terminal(s):
            continue
        assert can_transition(s, CtlState.CANCELLED), s


def test_crash_requeue_edges():
    owned = (CtlState.ADMITTED, CtlState.RUNNING, CtlState.PAGED, CtlState.MIGRATING)
    for s in owned:
        assert can_transition(s, CtlState.SUBMITTED), s
    assert can_transition(CtlState.PAUSED, CtlState.SUBMITTED)
    for s in TERMINAL:
        assert not can_transition(s, CtlState.SUBMITTED), s


def test_submitted_cannot_skip_admission():
    for dst in (CtlState.RUNNING, CtlState.PAGED, CtlState.MIGRATING, CtlState.FINISHED):
        with pytest.raises(InvalidTransition):
            validate_transition(CtlState.SUBMITTED, dst)


def test_finished_never_resubmits():
    with pytest.raises(InvalidTransition):
        validate_transition(CtlState.FINISHED, CtlState.SUBMITTED)


def test_engine_projection_is_total_and_sane():
    for es in JobState:
        assert isinstance(ctl_state_of(es), CtlState)
    assert ctl_state_of(JobState.PAUSED) is CtlState.RUNNING
    assert ctl_state_of(JobState.QUEUED) is CtlState.ADMITTED
    assert ctl_state_of(JobState.PAGED) is CtlState.PAGED
    assert ctl_state_of(JobState.CANCELLED) is CtlState.CANCELLED
    assert ctl_state_of(JobState.FINISHED, rejected=True) is CtlState.FAILED
    assert ctl_state_of(JobState.FINISHED) is CtlState.FINISHED


# ---------------------------------------------------------------------------
# the lifecycle table and the schema against JAX's
# ---------------------------------------------------------------------------


def test_lifecycle_tables_equal_by_member_names():
    assert [(s.name, s.value) for s in port_sm.CtlState] == [
        (s.name, s.value) for s in jax_sm.CtlState]
    assert _names(port_sm.TERMINAL) == _names(jax_sm.TERMINAL)
    assert {s.name: _names(d) for s, d in port_sm.TRANSITIONS.items()} == {
        s.name: _names(d) for s, d in jax_sm.TRANSITIONS.items()}
    assert {e.name: c.name for e, c in port_sm._ENGINE_TO_CTL.items()} == {
        e.name: c.name for e, c in jax_sm._ENGINE_TO_CTL.items()}
    for es in JobState:
        for rejected in (False, True):
            assert ctl_state_of(es, rejected).name == jax_sm.ctl_state_of(
                jax_types.JobState[es.name], rejected).name
    for src in CtlState:
        for dst in CtlState:
            assert can_transition(src, dst) == jax_sm.can_transition(
                jax_sm.CtlState[src.name], jax_sm.CtlState[dst.name]), (src, dst)


def _master(path):
    conn = sqlite3.connect(path)
    try:
        rows = conn.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master ORDER BY type, name").fetchall()
        mode = conn.execute("PRAGMA journal_mode").fetchone()[0]
    finally:
        conn.close()
    return rows, mode


def test_schema_equal_to_jax(tmp_path):
    assert port_store._SCHEMA == jax_store._SCHEMA
    for pkg, mod in STORES.items():
        mod.JobStore(str(tmp_path / f"{pkg}.sqlite")).close()
    port_rows, port_mode = _master(str(tmp_path / "port.sqlite"))
    jax_rows, jax_mode = _master(str(tmp_path / "jax.sqlite"))
    assert port_rows == jax_rows
    assert {r[1] for r in port_rows} >= {"jobs", "transitions", "decisions", "meta"}
    assert port_mode == jax_mode == "wal"


def _spec_pair(**kw):
    args = dict(name="svc", n_iters=3, iter_time=0.25, utilization=0.5, arrival_time=7.0,
                kind="inference", priority=2, request_times=(0.0, 1.0, 2.0),
                meta={"model": "res50"})
    args.update(kw)
    port = JobSpec(profile=MemoryProfile(300 * MB, 900 * MB), **args)
    ref = jax_types.JobSpec(profile=jax_types.MemoryProfile(300 * MB, 900 * MB), **args)
    port.job_id = ref.job_id = 41
    return port, ref


@pytest.mark.parametrize("kind", ["inference", "train"])
def test_spec_dict_equal_to_jax(kind):
    extra = {} if kind == "inference" else dict(request_times=None, priority=None, meta={})
    port, ref = _spec_pair(kind=kind, **extra)
    d = spec_to_dict(port)
    assert json.dumps(d) == json.dumps(jax_store.spec_to_dict(ref))
    back = jax_store.spec_from_dict(json.loads(json.dumps(d)))
    mine = spec_from_dict(json.loads(json.dumps(jax_store.spec_to_dict(ref))))
    for a, b in ((back, ref), (mine, port)):
        assert (a.job_id, a.name, a.n_iters, a.iter_time, a.utilization, a.arrival_time,
                a.kind, a.priority, a.request_times, a.meta) == (
            b.job_id, b.name, b.n_iters, b.iter_time, b.utilization, b.arrival_time,
            b.kind, b.priority, b.request_times, b.meta)
        assert (a.profile.persistent, a.profile.ephemeral) == (
            b.profile.persistent, b.profile.ephemeral)


def _write_history(mod, path):
    """The same lifecycle, progress, decisions and meta through ``mod``'s
    store; decisions carry the port's enum members, which both encoders
    flatten to their values."""
    s = mod.JobStore(path)
    sm = jax_sm if mod is jax_store else port_sm
    ids = []
    for name, n in (("a", 10), ("b", 20), ("c", 5)):
        d = {"job_id": s.next_job_id(), "name": name, "persistent": 200 * MB,
             "ephemeral": 800 * MB, "n_iters": n, "iter_time": 1.0}
        ids.append(s.add_job(d, now=1.0))
    a, b, c = ids
    with s.transaction():
        for jid in (a, b):
            s.set_state(jid, sm.CtlState.ADMITTED, reason="claimed by fleet run", now=2.0)
        s.set_state(a, sm.CtlState.RUNNING, reason="epoch observation", now=3.0)
        s.update_progress(a, 4, now=3.0)
        s.append_decisions("placement", [(PlacementEventKind.PLACE, 0, "a", 0)])
        s.append_decisions("device:0", [(MemoryEventKind.ADMIT, 0, "a", 0)])
    s.set_state(c, sm.CtlState.PAUSED, reason="submitted --hold", now=4.0)
    s.set_meta("note", "x")
    s.close()
    return ids


def _dump(mod, path):
    s = mod.JobStore(path)
    try:
        replayed = {jid: st.name for jid, st in s.replay().items()}
        jobs = [(r["job_id"], r["name"], r["spec"], r["state"].name, r["iterations_done"],
                 r["n_iters"], r["detail"]) for r in s.list_jobs()]
        return (replayed, jobs, s.transitions(), s.decision_log(), s.decision_sources(),
                s.get_meta("next_job_id"), s.get_meta("note"), s.counts(), s.all_terminal())
    finally:
        s.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_store_read_both_ways(tmp_path, writer):
    path = str(tmp_path / "jobs.sqlite")
    _write_history(STORES[writer], path)
    assert _dump(port_store, path) == _dump(jax_store, path)
    replayed, jobs, *_ = _dump(port_store, path)
    assert replayed == {0: "RUNNING", 1: "ADMITTED", 2: "PAUSED"}
    assert [j[4] for j in jobs] == [4, 0, 0]


# ---------------------------------------------------------------------------
# twins of tests/test_ctl_store.py
# ---------------------------------------------------------------------------


def _spec_dict(store, name="j", n_iters=10, **kw):
    d = {
        "job_id": store.next_job_id(),
        "name": name,
        "persistent": 200 * MB,
        "ephemeral": 800 * MB,
        "n_iters": n_iters,
        "iter_time": 1.0,
    }
    d.update(kw)
    return d


@pytest.fixture
def store(tmp_path):
    s = JobStore(str(tmp_path / "jobs.sqlite"))
    yield s
    s.close()


def test_spec_roundtrip_preserves_fields_and_id():
    job = JobSpec(
        name="svc",
        profile=MemoryProfile(300 * MB, 900 * MB),
        n_iters=3,
        iter_time=0.25,
        utilization=0.5,
        arrival_time=7.0,
        kind="inference",
        priority=2,
        request_times=(0.0, 1.0, 2.0),
        meta={"model": "res50"},
    )
    back = spec_from_dict(json.loads(json.dumps(spec_to_dict(job))))
    assert back.job_id == job.job_id
    assert back.profile == job.profile
    assert back.request_times == job.request_times
    assert back.priority == 2 and back.kind == "inference"
    assert back.meta == {"model": "res50"}


def test_unserializable_meta_is_dropped_not_fatal():
    job = JobSpec(name="j", profile=MemoryProfile(MB, MB), n_iters=1, iter_time=1.0,
                  meta={"fn": object()})
    assert spec_to_dict(job)["meta"] == {}


def test_add_job_records_creation_transition(store):
    jid = store.add_job(_spec_dict(store))
    row = store.get_job(jid)
    assert row["state"] is CtlState.SUBMITTED
    assert row["iterations_done"] == 0
    assert store.transitions(jid) == [
        (jid, None, "submitted", pytest.approx(row["submitted_at"]), "submit")]


def test_duplicate_job_id_raises(store):
    d = _spec_dict(store)
    store.add_job(d)
    with pytest.raises(DuplicateJob):
        store.add_job(d)


def test_set_state_validates_and_records_history(store):
    jid = store.add_job(_spec_dict(store))
    store.set_state(jid, CtlState.ADMITTED, reason="claim")
    store.set_state(jid, CtlState.RUNNING)
    with pytest.raises(InvalidTransition):
        store.set_state(jid, CtlState.ADMITTED)
    store.set_state(jid, CtlState.FINISHED)
    with pytest.raises(InvalidTransition):
        store.set_state(jid, CtlState.SUBMITTED)
    assert [t[2] for t in store.transitions(jid)] == [
        "submitted", "admitted", "running", "finished"]
    store.set_state(jid, CtlState.FINISHED)
    assert len(store.transitions(jid)) == 4


def test_set_state_unknown_job(store):
    with pytest.raises(KeyError):
        store.set_state(999, CtlState.ADMITTED)


def test_progress_is_monotone(store):
    jid = store.add_job(_spec_dict(store, n_iters=50))
    store.update_progress(jid, 10)
    store.update_progress(jid, 10)
    store.update_progress(jid, 30)
    with pytest.raises(StoreCorruption):
        store.update_progress(jid, 20)
    assert store.get_job(jid)["iterations_done"] == 30


def test_decision_log_append_and_roundtrip(store):
    entries = [("admit", 0, "a", 0), ("queue", 1, "b", None)]
    assert store.append_decisions("device:0", entries) == 2
    store.append_decisions("placement", [("place", 0, "a", 0)])
    assert store.decision_log("device:0") == entries
    assert store.decision_count() == 3
    assert store.decision_sources() == ["device:0", "placement"]


def test_next_job_id_is_durable(tmp_path):
    path = str(tmp_path / "jobs.sqlite")
    s1 = JobStore(path)
    ids = [s1.next_job_id() for _ in range(3)]
    s1.close()
    s2 = JobStore(path)
    assert s2.next_job_id() == ids[-1] + 1
    s2.close()


def test_replay_accepts_clean_history(store):
    a = store.add_job(_spec_dict(store, name="a"))
    b = store.add_job(_spec_dict(store, name="b"))
    store.set_state(a, CtlState.ADMITTED)
    store.set_state(a, CtlState.RUNNING)
    store.set_state(a, CtlState.FINISHED)
    store.set_state(b, CtlState.CANCELLED)
    assert store.replay() == {a: CtlState.FINISHED, b: CtlState.CANCELLED}


def test_replay_detects_tampered_state(store):
    jid = store.add_job(_spec_dict(store))
    store.set_state(jid, CtlState.ADMITTED)
    conn = sqlite3.connect(store.path)
    conn.execute("UPDATE jobs SET state = 'finished' WHERE job_id = ?", (jid,))
    conn.commit()
    conn.close()
    with pytest.raises(StoreCorruption):
        store.replay()


def test_replay_detects_illegal_hop_in_history(store):
    jid = store.add_job(_spec_dict(store))
    conn = sqlite3.connect(store.path)
    conn.execute(
        "INSERT INTO transitions (job_id, src, dst, at, reason)"
        " VALUES (?, 'submitted', 'running', 0.0, 'forged')",
        (jid,),
    )
    conn.execute("UPDATE jobs SET state = 'running' WHERE job_id = ?", (jid,))
    conn.commit()
    conn.close()
    with pytest.raises(StoreCorruption):
        store.replay()


def test_replay_detects_progress_overrun(store):
    jid = store.add_job(_spec_dict(store, n_iters=5))
    conn = sqlite3.connect(store.path)
    conn.execute("UPDATE jobs SET iterations_done = 9 WHERE job_id = ?", (jid,))
    conn.commit()
    conn.close()
    with pytest.raises(StoreCorruption):
        store.replay()


def test_transaction_rolls_back_atomically(store):
    jid = store.add_job(_spec_dict(store))
    with pytest.raises(RuntimeError):
        with store.transaction():
            store.set_state(jid, CtlState.ADMITTED)
            store.append_decisions("placement", [("place", 0, "j", 0)])
            raise RuntimeError("boom")
    assert store.get_job(jid)["state"] is CtlState.SUBMITTED
    assert store.decision_count() == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's ctl phase, rehearsed on the CPU
# ---------------------------------------------------------------------------


def test_chip_smoke_ctl_phase(monkeypatch):
    monkeypatch.setattr(chip_smoke, "nvidia_smi", lambda: "no card")
    res = chip_smoke.phase_ctl()
    assert res["jobs"] == 3 and res["requeued"] >= 1
    assert 0 < res["log_before_kill"] < res["log_after"]
    assert any(it > 0 for it in res["at_kill"].values())
