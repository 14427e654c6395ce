"""The port's framework-free fleet core against the JAX package's, on the
CPU: the event core (``repro_torch.core.events``), the trace generators
(``core.tracegen``), the paper tables (``core.profiles``), the fault tools
(``repro_torch.dist.fault``) and the Engine surface (``core.engine``).
None of these does floating-point work that could differ between the two
packages, so every comparison is exact. Twins of
``tests/test_fleet_events.py``'s EventQueue/EpochSchedule tests, of
``tests/test_fault.py``'s host-side tests and of
``tests/test_engine_api.py``'s single-device tests, run on the port."""
import dataclasses
import json
import random
import time
from itertools import islice

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

from repro.core import MemoryConfig as JaxMemoryConfig  # noqa: E402
from repro.core import Simulator as JaxSimulator  # noqa: E402
from repro.core import engine as jax_engine  # noqa: E402
from repro.core import get_policy as jax_get_policy  # noqa: E402
from repro.core import profiles as jax_profiles  # noqa: E402
from repro.core import tracegen as jax_tracegen  # noqa: E402
from repro.core.events import EventQueue as JaxEventQueue  # noqa: E402
from repro.core.types import JobSpec as JaxJobSpec  # noqa: E402
from repro.core.types import MemoryEventKind as JaxMemoryEventKind  # noqa: E402
from repro.core.types import MemoryProfile as JaxMemoryProfile  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GB,
    DecisionLog,
    Engine,
    JobSpec,
    MemoryConfig,
    MemoryEventKind,
    MemoryProfile,
    ResultSurface,
    SalusExecutor,
    Simulator,
    decode_decision_log,
    encode_decision,
    encode_decision_log,
    get_policy,
)
from repro_torch.core import profiles, tracegen  # noqa: E402
from repro_torch.core.events import EpochSchedule, EventQueue, as_schedule  # noqa: E402
from repro_torch.core.scheduler import PACK, SRTF  # noqa: E402
from repro_torch.core.session import Session  # noqa: E402
from repro_torch.dist.fault import (  # noqa: E402
    FailureInjector,
    InjectedFailure,
    RestartSupervisor,
    StragglerMonitor,
)

CPU = torch.device("cpu")


def _job(name="j", t=0.0):
    return JobSpec(name=name, profile=MemoryProfile(GB, GB), n_iters=1, iter_time=0.01,
                   arrival_time=t)


# ---------------------------------------------------------------------------
# EventQueue / EpochSchedule (twins of tests/test_fleet_events.py)
# ---------------------------------------------------------------------------


def test_pop_batch_groups_ulp_smeared_ties_in_push_order():
    q = EventQueue()
    a, b, c = _job("a"), _job("b"), _job("c")
    q.push(1.0 + 2e-10, "iter_done", a)
    q.push(1.0, "iter_done", b)
    q.push(1.0 + 1e-10, "iter_done", c)
    q.push(1.5, "arrival", _job("later"))
    batch = q.pop_batch()
    assert [ev[3].name for ev in batch] == ["a", "b", "c"]
    assert q.now == 1.0
    assert q.peek_time() == 1.5


def test_pop_batch_keeps_distinct_instants_apart():
    q = EventQueue()
    q.push(1.0, "x", _job("a"))
    q.push(1.001, "x", _job("b"))
    assert [ev[3].name for ev in q.pop_batch()] == ["a"]
    assert [ev[3].name for ev in q.pop_batch()] == ["b"]


def test_pop_batch_honors_until_and_clamp_advances_clock():
    q = EventQueue()
    q.push(5.0, "x", _job())
    assert q.pop_batch(until=4.0) is None
    assert q.now == 0.0
    q.clamp(4.0)
    assert q.now == 4.0
    assert q.pop_batch(until=5.0) is not None
    assert q.now == 5.0
    assert q.pop_batch() is None
    q.clamp(3.0)
    assert q.now == 5.0


def test_generation_invalidation_marks_inflight_events_stale():
    q = EventQueue()
    a, b = _job("a"), _job("b")
    q.push(1.0, "iter_done", a)
    q.push(1.0, "iter_done", b)
    q.invalidate(a.job_id)
    evs = {ev[3].name: ev for ev in q.pop_batch()}
    assert q.is_stale(evs["a"]) and not q.is_stale(evs["b"])
    q.push(2.0, "iter_done", a)
    (ev,) = q.pop_batch()
    assert not q.is_stale(ev)


def test_defer_bulk_load_restores_heap_order_lazily():
    q = EventQueue()
    q.defer()
    times = [7.0, 1.0, 4.0, 2.0, 9.0, 3.0]
    for i, t in enumerate(times):
        q.push(t, "arrival", _job(f"j{i}", t))
    assert len(q) == len(times)
    assert q.peek_time() == 1.0
    popped = []
    while q:
        popped.extend(ev[0] for ev in q.pop_batch())
    assert popped == sorted(times)


def test_epoch_boundaries_are_bitwise_repeated_addition():
    sched = EpochSchedule(0.02)
    t, expect = 0.0, []
    for _ in range(1000):
        t = t + 0.02
        expect.append(t)
    got = []
    t = 0.0
    for _ in range(1000):
        t = sched.next_boundary(t)
        got.append(t)
    assert got == expect
    assert list(islice(sched.boundaries(), 1000)) == expect


def test_as_schedule_coercion():
    assert as_schedule(None) is None
    s = EpochSchedule(1.0)
    assert as_schedule(s) is s
    assert as_schedule(0.5).interval == 0.5
    with pytest.raises(ValueError):
        EpochSchedule(0.0)


def _queue_script(queue_cls, spec_cls, profile_cls, seed, n_ops=400):
    """One random script of pushes (ulp-smeared ties among them), pops,
    batch pops under a horizon, clamps, invalidations and a bulk load,
    replayed on ``queue_cls``: everything the queue reports, as plain
    values."""
    rng = random.Random(seed)
    jobs = [spec_cls(name=f"j{i}", profile=profile_cls(GB, GB), n_iters=1, iter_time=0.01)
            for i in range(6)]
    q, out = queue_cls(), []
    view = lambda ev: (ev[0], ev[2], ev[3].name, ev[4], q.is_stale(ev))  # noqa: E731
    for _ in range(n_ops):
        op = rng.random()
        if op < 0.45:
            t = round(q.now + rng.choice([0.0, 0.5, 1.0, 2.5]), 3) + rng.choice([0.0, 1e-10, 3e-10])
            q.push(t, rng.choice(["arrival", "iter_done", "request"]), rng.choice(jobs))
        elif op < 0.6:
            out.append(("pop", view(q.pop()) if q else None))
        elif op < 0.8:
            until = rng.choice([None, q.now + 1.0])
            batch = q.pop_batch(until)
            out.append(("batch", None if batch is None else [view(ev) for ev in batch]))
        elif op < 0.87:
            q.clamp(q.now + rng.choice([0.0, 0.7]))
        elif op < 0.95:
            out.append(("gen", q.invalidate(rng.choice(jobs).job_id)))
        else:
            q.defer()
        out.append((q.now, len(q), q.peek_time()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_queue_script_matches_jax(seed):
    assert _queue_script(EventQueue, JobSpec, MemoryProfile, seed) == _queue_script(
        JaxEventQueue, JaxJobSpec, JaxMemoryProfile, seed)


# ---------------------------------------------------------------------------
# trace generators and paper tables
# ---------------------------------------------------------------------------


def _fields(job):
    """Every JobSpec field but ``job_id`` (a process-wide counter), the
    profile as its two byte counts."""
    out = []
    for f in dataclasses.fields(job):
        v = getattr(job, f.name)
        out.append((v.persistent, v.ephemeral) if f.name == "profile" else v)
    return tuple(out)


GENERATORS = {
    "generate_trace": lambda m, seed: m.generate_trace(seed=seed),
    "cluster_trace": lambda m, seed: m.cluster_trace(seed=seed),
    "request_trace": lambda m, seed: m.request_trace(seed=seed, train_background="vae_256"),
    "churn_trace": lambda m, seed: m.churn_trace(seed=seed),
    "diurnal_trace": lambda m, seed: m.diurnal_trace(n_jobs=2000, seed=seed),
    "hyperparam_trace": lambda m, seed: m.hyperparam_trace("resnet50_25", seed=seed),
}


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_jax_job_for_job(name, seed):
    ours = GENERATORS[name](tracegen, seed)
    theirs = GENERATORS[name](jax_tracegen, seed)
    assert len(ours) == len(theirs) > 0
    assert [_fields(j) for j in ours] == [_fields(j) for j in theirs]


def test_paper_tables_match_jax():
    assert profiles.PAPER_WORKLOADS == jax_profiles.PAPER_WORKLOADS
    assert profiles.P100_CAPACITY == jax_profiles.P100_CAPACITY
    assert tracegen.SERVING_POOL == jax_tracegen.SERVING_POOL
    for name in sorted(profiles.PAPER_WORKLOADS):
        p, jp = profiles.paper_profile(name), jax_profiles.paper_profile(name)
        assert (p.persistent, p.ephemeral) == (jp.persistent, jp.ephemeral)
        for kind in ("train", "inference"):
            assert _fields(profiles.paper_job(name, 7, 1.5, kind)) == _fields(
                jax_profiles.paper_job(name, 7, 1.5, kind))
        (prof, t), (jprof, jt) = profiles.inference_profile(name), jax_profiles.inference_profile(name)
        assert (prof.persistent, prof.ephemeral, t) == (jprof.persistent, jprof.ephemeral, jt)


# ---------------------------------------------------------------------------
# fault tools (twins of tests/test_fault.py's host-side tests)
# ---------------------------------------------------------------------------


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(k=3.0, warmup=5)
    for i in range(20):
        mon.observe(i, 1.0 + 0.01 * (i % 3))
    rep = mon.observe(20, 5.0)
    assert rep is not None and rep.sigma > 3.0
    assert len(mon.flagged) == 1


def test_straggler_monitor_quiet_on_steady_steps():
    mon = StragglerMonitor(k=3.0, warmup=5)
    rng = np.random.default_rng(0)
    flags = [mon.observe(i, 1.0 + 0.005 * rng.standard_normal()) for i in range(100)]
    assert sum(r is not None for r in flags) <= 2


def test_injector_fires_once():
    inj = FailureInjector([3])
    inj.maybe_fail(2)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(3)
    inj.maybe_fail(3)


def test_restart_supervisor_budget():
    sup = RestartSupervisor(max_restarts=2)

    def body(start):
        raise InjectedFailure("boom")

    with pytest.raises(RuntimeError, match="restart budget"):
        sup.run(body, resume_step=lambda: 0)
    assert sup.restarts == 3


# ---------------------------------------------------------------------------
# decision-log encoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("paging", [False, True])
def test_decision_log_encoding_matches_jax(paging):
    """The JSON of a real decision log (a 40-job trace with its arrivals
    packed close, so that queues, second chances and page moves occur) is
    the JSON the JAX package writes for its own run, and it decodes back
    to the log."""
    mk = lambda m: m.generate_trace(n_jobs=40, seed=3, mean_interarrival=0.5)  # noqa: E731
    jobs, jjobs = mk(tracegen), mk(jax_tracegen)
    for j, jj in zip(jobs, jjobs):
        j.n_iters = jj.n_iters = min(j.n_iters, 40)
    log = Simulator(16 * GB, get_policy("srtf"), memory=MemoryConfig(paging=paging)).run(jobs)
    jlog = JaxSimulator(16 * GB, jax_get_policy("srtf"),
                        memory=JaxMemoryConfig(paging=paging)).run(jjobs)
    text = json.dumps(encode_decision_log(log.decision_log))
    assert text == json.dumps(jax_engine.encode_decision_log(jlog.decision_log))
    assert decode_decision_log(json.loads(text)) == list(log.decision_log)
    kinds = {k for k, *_ in log.decision_log}
    assert {"queue"} <= kinds and (not paging or {"page_out", "page_in"} <= kinds)
    entry = (MemoryEventKind.PAGE_OUT, 4, "a", 2)
    assert encode_decision(entry) == jax_engine.encode_decision(
        (JaxMemoryEventKind.PAGE_OUT, 4, "a", 2)) == ["page_out", 4, "a", 2]


# ---------------------------------------------------------------------------
# Engine API (twins of tests/test_engine_api.py's single-device tests)
# ---------------------------------------------------------------------------

CAP = int(16 * GB)
PROF = MemoryProfile(int(2 * GB), int(3 * GB))


def _jobs(n=3, n_iters=4, iter_time=0.002):
    return [JobSpec(name=f"j{i}", profile=PROF, n_iters=n_iters, iter_time=iter_time,
                    utilization=1.0, arrival_time=0.0) for i in range(n)]


def _sessions(n=2, n_iters=3, iter_time=0.002):
    out = []
    for i in range(n):

        def step(state, batch, _t=iter_time):
            time.sleep(_t)
            return state

        out.append(Session(f"s{i}", step, torch.zeros(4), lambda i: None, n_iters, profile=PROF,
                           iter_time=iter_time, utilization=1.0, arrival_time=0.0, device=CPU))
    return out


def _executor():
    return SalusExecutor(CAP, get_policy("srtf"), accounting="nominal", device=CPU)


def test_both_backends_satisfy_engine_protocol():
    assert isinstance(Simulator(CAP, get_policy("srtf")), Engine)
    assert isinstance(_executor(), Engine)


def test_engine_generic_driver_runs_either_single_device_backend():
    def drive(engine, work):
        for w in work:
            engine.submit(w)
        engine.run()
        res = engine.result()
        return res.completed, res.avg_jct, engine.decision_log()

    n_sim, jct_sim, log_sim = drive(Simulator(CAP, get_policy("srtf")), _jobs(n=2, n_iters=3))
    n_ex, jct_ex, log_ex = drive(_executor(), _sessions(n=2, n_iters=3))
    assert n_sim == n_ex == 2
    assert jct_sim > 0 and jct_ex > 0
    assert [e[0] for e in log_sim] == [e[0] for e in log_ex]


def _check_surface(res, n_jobs):
    assert isinstance(res, ResultSurface)
    assert res.completed == n_jobs
    assert len(res.per_job) == n_jobs
    assert res.per_job == res.stats
    assert len(res.jcts) == n_jobs
    assert res.avg_jct > 0
    assert res.p95_jct >= max(res.jcts) * 0.99 or res.p95_jct in res.jcts
    assert 0.0 <= res.utilization
    assert res.makespan > 0
    assert isinstance(res.request_latencies, list)


def test_result_surface_simulator():
    _check_surface(Simulator(CAP, get_policy("srtf")).run(_jobs(3)), 3)


def test_result_surface_executor():
    ex = _executor()
    for s in _sessions(2):
        ex.submit(s)
    _check_surface(ex.run(), 2)


def test_decision_log_is_list_and_callable():
    log = Simulator(CAP, get_policy("srtf")).run(_jobs(2)).decision_log
    assert isinstance(log, DecisionLog) and isinstance(log, list)
    assert log() == list(log)
    assert log and log[0][0] == "admit"


def test_lookups_accept_instances_and_any_case():
    assert isinstance(get_policy("SRTF"), SRTF)
    assert isinstance(get_policy("Pack"), PACK)
    pol = SRTF()
    assert get_policy(pol) is pol


def test_lookups_raise_keyerror_for_unknown_typeerror_for_junk():
    with pytest.raises(KeyError):
        get_policy("edf")
    with pytest.raises(TypeError):
        get_policy(3.14)
