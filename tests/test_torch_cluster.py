"""Salus's fleet in the port (``repro_torch.core.cluster``, ``fleet``, and
the migration surface of the simulator, executor, memory manager and
lanes) against the JAX package's, on the CPU.

* The port's ``Cluster`` against JAX's: placement, migration and
  per-device decision logs, records and stats over ``cluster_trace`` and
  ``churn_trace`` seeds 0-4, paging off and on, with and without a
  ``FailureInjector``; twins of ``tests/test_migration.py``'s ``Cluster``
  tests. Simulation does the same float arithmetic in both packages, so
  every comparison is exact.
* The ``Simulator``'s migration surface against JAX's: ``migrate_out``
  returns and the logs after ``drain_running``, ``remove_pending``,
  ``cancel`` and the ``start(done=)`` resume point.
* ``FleetDriver``: twins of ``tests/test_fleet_events.py``'s four tests.
* The port's live ``ClusterExecutor`` on ``device="cpu"`` with
  torch-tensor sessions that sleep their declared time, against the
  port's ``Cluster`` under nominal accounting: twins of
  ``test_concurrent_fleet_mirrors_cluster_simulator``, the threads
  against sequential self-differential, the migration differential and
  its failure parity.
* The launch counters stay exact when threads launch at once.
* ``chip_smoke.py``'s fleet phase helpers at gemma-2b smoke on the CPU.
"""
import dataclasses
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import repro.core as jax_core  # noqa: E402
import repro.core.tracegen as jax_tracegen  # noqa: E402
import repro.dist.fault as jax_fault  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.dist.fault as port_fault  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GB,
    Cluster,
    ClusterExecutor,
    JobSpec,
    JobState,
    MemoryConfig,
    MemoryProfile,
    Rebalancer,
    Session,
    Simulator,
    get_policy,
)
from repro_torch.core import tracegen  # noqa: E402
from repro_torch.core.fleet import FleetDriver  # noqa: E402
from repro_torch.dist.fault import FailureInjector  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

import chip_smoke  # noqa: E402

CPU = torch.device("cpu")
CAP = int(16 * GB)
MEMCFG = dict(page_bandwidth=1e12)  # transfers modeled ~free, as in the JAX suite


def _jobs(pkg, specs):
    """JobSpecs of ``pkg`` ("jax" or "port") from (name, p_gb, e_gb,
    n_iters, iter_time, arrival, utilization) tuples."""
    m = jax_core if pkg == "jax" else port_core
    return [m.JobSpec(name=n, profile=m.MemoryProfile(int(p * m.GB), int(e * m.GB)),
                      n_iters=k, iter_time=t, arrival_time=a, utilization=u)
            for n, p, e, k, t, a, u in specs]


def _cluster(pkg, *args, injector=None, **kw):
    m = jax_core if pkg == "jax" else port_core
    fault = jax_fault if pkg == "jax" else port_fault
    if "memory" in kw:
        kw["memory"] = m.MemoryConfig(**kw["memory"])
    if "rebalancer" in kw:
        kw["rebalancer"] = m.Rebalancer(**kw["rebalancer"])
    return m.Cluster(*args, fault_injector=fault.FailureInjector(injector) if injector else None,
                     **kw)


def result_view(res):
    """A ``ClusterResult`` by job name (job ids differ between packages)."""
    names = {j: s.name for j, s in res.jobs.items()}
    return (res.placement_log(), res.migration_log(),
            [list(r.decision_log) for r in res.device_results],
            sorted((names[r.job_id], r.index, r.start, r.end, r.lane_id) for r in res.records),
            {names[j]: (st.iterations_done, st.finish_time, st.migrations, st.transfer_time,
                        st.page_outs, st.page_ins, st.rejected) for j, st in res.stats.items()},
            res.makespan, res.devices_used)


def both(run):
    """``run("jax")`` and ``run("port")`` held equal; the port's result."""
    jax_res, port_res = run("jax"), run("port")
    assert result_view(jax_res) == result_view(port_res)
    return port_res


# ---------------------------------------------------------------------------
# the port's Cluster against JAX's
# ---------------------------------------------------------------------------


def _trace(pkg, trace, seed):
    tg = jax_tracegen if pkg == "jax" else tracegen
    if trace == "churn":
        return tg.churn_trace(n_devices=3, seed=seed, long_iters=300, short_iters=30,
                              big_arrival=60.0, big_iters=10)
    # iterations capped so that a run takes milliseconds; least-loaded
    # placement spreads the jobs and the consolidate pass migrates them
    return [dataclasses.replace(j, n_iters=min(j.n_iters, 200))
            for j in tg.cluster_trace(3, jobs_per_device=4, seed=seed)]


@pytest.mark.parametrize("injector", [None, [1]], ids=["no_fault", "fault_1"])
@pytest.mark.parametrize("paging", [False, True], ids=["paging_off", "paging_on"])
@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("trace", ["cluster", "churn"])
def test_cluster_matches_jax(trace, seed, paging, injector):
    strategy, interval = ("consolidate", 50.0) if trace == "churn" else ("least_loaded", 100.0)
    res = both(lambda pkg: _cluster(
        pkg, 3, CAP, "srtf" if trace == "cluster" else "pack", strategy=strategy,
        memory=dict(paging=paging), rebalancer=dict(mode="consolidate"),
        rebalance_interval=interval, injector=injector).run(_trace(pkg, trace, seed)))
    kinds = {e[0] for e in res.migration_log()}
    if trace == "churn":
        assert "migrate" in kinds
        assert ("migrate_failed" in kinds) == bool(injector)
    assert res.completed == len(res.jobs)


def _churn(pkg):
    """bench_migration's --fast churn scenario, as tests/test_migration.py."""
    tg = jax_tracegen if pkg == "jax" else tracegen
    return tg.churn_trace(n_devices=3, capacity=CAP, long_iters=500, short_iters=40,
                          big_arrival=75.0, big_iters=15)


def test_defrag_by_migration_shrinks_devices_used():
    arrival = both(lambda pkg: _cluster(pkg, 3, CAP, "pack", strategy="consolidate")
                   .run(_churn(pkg)))
    rebal = both(lambda pkg: _cluster(pkg, 3, CAP, "pack", strategy="consolidate",
                                      rebalancer=dict(mode="consolidate"),
                                      rebalance_interval=50.0).run(_churn(pkg)))
    assert arrival.completed == rebal.completed == 5
    assert rebal.devices_used < arrival.devices_used
    kinds = [k for k, *_ in rebal.migration_log()]
    assert "migrate" in kinds and "replace" in kinds
    moved = [m for m in rebal.migrations if m.reason == "consolidate"]
    assert moved
    for m in moved:
        st = rebal.stats[m.job_id]
        assert st.migrations >= 1 and st.transfer_time > 0.0


def test_epoch_loop_without_migrations_is_bitwise_neutral():
    specs = [("a", 2.4, 4.0, 37, 1.0, 0.0, 0.4), ("b", 2.4, 4.0, 11, 1.0, 0.0, 0.4),
             ("c", 2.4, 4.0, 23, 1.0, 0.0, 0.4), ("d", 6.0, 9.0, 7, 1.0, 0.0, 0.4)]
    plain = both(lambda pkg: _cluster(pkg, 2, CAP, "srtf", strategy="least_loaded")
                 .run(_jobs(pkg, specs)))
    chopped = both(lambda pkg: _cluster(pkg, 2, CAP, "srtf", strategy="least_loaded",
                                        rebalancer=dict(mode="none"), rebalance_interval=5.0)
                   .run(_jobs(pkg, specs)))
    assert chopped.migration_log() == []
    assert plain.decision_log() == chopped.decision_log()
    view_plain, view_chopped = result_view(plain), result_view(chopped)
    assert view_plain[3] == view_chopped[3]  # records, start and end included
    assert plain.makespan == chopped.makespan


def test_migration_conservation_under_injected_failure():
    res = both(lambda pkg: _cluster(pkg, 3, CAP, "pack", strategy="consolidate",
                                    rebalancer=dict(mode="consolidate"), rebalance_interval=50.0,
                                    injector=[1]).run(_churn(pkg)))
    assert len([e for e in res.migration_log() if e[0] == "migrate_failed"]) == 1
    assert res.completed == 5
    for jid, st in res.stats.items():
        assert st.iterations_done == res.jobs[jid].n_iters


# ---------------------------------------------------------------------------
# the Simulator's migration surface against JAX's
# ---------------------------------------------------------------------------

SURFACE = [("a", 2.4, 4.0, 30, 1.0, 0.0, 0.5), ("b", 2.4, 4.0, 12, 1.5, 0.0, 0.5),
           ("c", 1.0, 2.0, 8, 1.0, 40.0, 0.5)]


def _surface_run(pkg, paging):
    """Two simulators driven by hand through an epoch boundary: advance,
    drain, ``migrate_out`` a job of the first into the second, re-place the
    not-yet-arrived job, cancel another, then run both to the end."""
    m = jax_core if pkg == "jax" else port_core
    jobs = _jobs(pkg, SURFACE)
    a, b, c = jobs
    cfg = m.MemoryConfig(paging=paging)
    src = m.Simulator(CAP, m.get_policy("srtf"), memory=cfg)
    dst = m.Simulator(CAP, m.get_policy("srtf"), memory=cfg)
    src.start([a, b, c])
    dst.start([])
    src.advance(10.0)
    src.drain_running()
    out = {"arrived": [src.has_arrived(j.job_id) for j in jobs],
           "pending": src.pending_events}
    st, carry = src.migrate_out(a)
    out["out"] = (st.iterations_done, carry, st.transfer_time)
    dst.migrate_in(a, st, now=10.0, extra_delay=carry)
    src.remove_pending(c)
    dst.add_pending(c)
    cancelled = src.cancel(b)
    out["cancel"] = (cancelled.iterations_done, cancelled.finish_time)
    for sim in (src, dst):
        sim.advance(None)
    out["logs"] = [list(src.memory.decision_log()), list(dst.memory.decision_log())]
    out["states"] = [sorted((j.name, s.value) for j in jobs if (s := sim._state.get(j.job_id)))
                     for sim in (src, dst)]
    res = dst.result()
    out["dst"] = sorted((r.index, r.start, r.end) for r in res.records if r.job_id == a.job_id)
    out["done"] = {j.name: res.stats[j.job_id].iterations_done for j in (a, c)}
    return out


@pytest.mark.parametrize("paging", [False, True])
def test_simulator_migration_surface_matches_jax(paging):
    jax_out, port_out = _surface_run("jax", paging), _surface_run("port", paging)
    assert jax_out == port_out
    assert port_out["arrived"] == [True, True, False]
    assert any(k == "migrate_out" for k, *_ in port_out["logs"][0])
    assert any(k == "migrate_in" for k, *_ in port_out["logs"][1])
    assert port_out["done"] == {"a": 30, "c": 8}
    assert ("b", JobState.CANCELLED.value) in port_out["states"][0]


def test_simulator_resumes_from_done_and_refuses_bad_points():
    def run(pkg):
        m = jax_core if pkg == "jax" else port_core
        jobs = _jobs(pkg, SURFACE[:2])
        sim = m.Simulator(CAP, m.get_policy("fifo"))
        sim.start(jobs, done={jobs[0].job_id: 25})
        sim.advance(None)
        res = sim.result()
        return [(r.index, r.start, r.end) for r in res.records], list(res.decision_log)

    assert run("jax") == run("port")
    assert run("port")[0][0][0] == 25  # the first iteration run is a's 26th
    job = _jobs("port", SURFACE[:1])[0]
    with pytest.raises(ValueError):
        Simulator(CAP, get_policy("fifo")).start([job], done={job.job_id: 30})


# ---------------------------------------------------------------------------
# FleetDriver (twins of tests/test_fleet_events.py)
# ---------------------------------------------------------------------------


def test_map_epoch_runs_workers_concurrently_and_orders_results():
    n = 4
    gate = threading.Barrier(n, timeout=10.0)

    def body(i):
        gate.wait()  # every worker inside its epoch body at once
        return i * 10

    with FleetDriver(n) as driver:
        for _ in range(2):
            assert driver.map_epoch([lambda i=i: body(i) for i in range(n)]) == [0, 10, 20, 30]


def test_map_epoch_reraises_lowest_worker_error_deterministically():
    def boom(i):
        raise RuntimeError(f"dev{i}")

    with FleetDriver(3) as driver:
        with pytest.raises(RuntimeError, match="dev1"):
            driver.map_epoch([lambda: 0, lambda: boom(1), lambda: boom(2)])
        assert driver.map_epoch([lambda: 1, lambda: 2, lambda: 3]) == [1, 2, 3]


def test_driver_close_is_idempotent_and_fails_further_epochs():
    driver = FleetDriver(2)
    driver.close()
    driver.close()
    with pytest.raises(RuntimeError, match="closed"):
        driver.map_epoch([lambda: 0, lambda: 1])


def test_map_epoch_rejects_wrong_arity():
    with FleetDriver(2) as driver:
        with pytest.raises(ValueError):
            driver.map_epoch([lambda: 0])


# ---------------------------------------------------------------------------
# the live ClusterExecutor on the CPU against the port's Cluster
# ---------------------------------------------------------------------------


def _session(name, profile, n_iters, iter_time):
    def step(state, batch):
        time.sleep(iter_time)  # stand-in for a real device iteration
        return state + 1.0

    return Session(name, step, torch.zeros(4), lambda i: None, n_iters, profile=profile,
                   iter_time=iter_time, utilization=1.0, arrival_time=0.0, device=CPU)


def _specs(seed, n_jobs=8, max_iters=3):
    """tests/test_fleet_events.py's ``_specs``, from the port's tracegen."""
    return [dict(name=f"{i}:{j.name}", profile=j.profile,
                 n_iters=max(2, min(j.n_iters, max_iters)),
                 iter_time=round(min(max(j.iter_time * 0.02, 0.002), 0.02), 6))
            for i, j in enumerate(tracegen.generate_trace(n_jobs=n_jobs, seed=seed))]


def _run_fleet(specs, paging, concurrency="threads", **kw):
    cex = ClusterExecutor(3, CAP, kw.pop("policy", "fifo"), strategy="least_loaded",
                          memory=MemoryConfig(paging=paging, **kw.pop("memcfg", MEMCFG)),
                          accounting="nominal", concurrency=concurrency, device="cpu", **kw)
    for s in specs:
        cex.submit(_session(s["name"], s["profile"], s["n_iters"], s["iter_time"]))
    rep = cex.run()
    names = {jid: sess.name for ex in cex.executors for jid, sess in ex.sessions.items()}
    return cex, rep, names


@pytest.mark.parametrize(
    "seed,paging", [(1, False), (5, False), (9, False), (1, True), (5, True), (9, True)]
)
def test_concurrent_fleet_mirrors_cluster_simulator(seed, paging):
    specs = _specs(seed)
    csim = Cluster(3, CAP, "fifo", strategy="least_loaded",
                   memory=MemoryConfig(paging=paging, **MEMCFG)).run(
        [JobSpec(name=s["name"], profile=s["profile"], n_iters=s["n_iters"],
                 iter_time=s["iter_time"], utilization=1.0, arrival_time=0.0) for s in specs])
    _, rep, names = _run_fleet(specs, paging)
    assert csim.placement_log() == rep.placement_log()
    for dev in range(3):
        assert csim.device_results[dev].decision_log == rep.device_reports[dev].decision_log
    sim_done = {csim.jobs[j].name for j, st in csim.stats.items() if st.finish_time is not None}
    assert sim_done == {names[j] for j, st in rep.stats.items() if st.finish_time is not None}


_WALL_STAMPS = {"arrival_time", "admit_time", "first_run_time", "finish_time"}


@pytest.mark.parametrize("seed,paging", [(1, False), (5, True), (9, True)])
def test_threaded_fleet_matches_sequential_loop_byte_for_byte(seed, paging):
    specs = _specs(seed)
    cth, rth, nth = _run_fleet(specs, paging, concurrency="threads")
    cse, rse, nse = _run_fleet(specs, paging, concurrency="sequential")
    assert cth.decision_log() == cse.decision_log()
    for dev in range(3):
        assert rth.device_reports[dev].decision_log == rse.device_reports[dev].decision_log
        assert ([(nth[r.job_id], r.index, r.lane_id) for r in rth.device_reports[dev].records]
                == [(nse[r.job_id], r.index, r.lane_id) for r in rse.device_reports[dev].records])
    sth = {nth[j]: st for j, st in rth.stats.items()}
    sse = {nse[j]: st for j, st in rse.stats.items()}
    assert set(sth) == set(sse)
    for name in sth:
        for f in dataclasses.fields(sth[name]):
            if f.name not in _WALL_STAMPS:
                assert getattr(sth[name], f.name) == getattr(sse[name], f.name), (name, f.name)


def test_fleet_rejects_unknown_concurrency_and_needs_a_device():
    with pytest.raises(ValueError):
        ClusterExecutor(2, CAP, "fifo", concurrency="processes", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ClusterExecutor(2, CAP, "fifo")  # the default is the card
    cex = ClusterExecutor(2, CAP, "fifo", device="cpu")
    assert [ex.device for ex in cex.executors] == [CPU, CPU]


# tests/test_migration.py's differential shape
SPECS = [("longA", 40), ("medB", 6), ("medC", 6), ("longD", 40)]
IT = 0.002
FRAG = MemoryProfile(int(2.4 * GB), int(4.0 * GB))


def _migration_fleet(cls, paging, injector=None, **kw):
    return cls(3, CAP, "srtf", strategy="least_loaded", memory=MemoryConfig(paging=paging),
               rebalancer=Rebalancer(mode="consolidate"), rebalance_interval=0.02,
               fault_injector=FailureInjector(injector) if injector else None, **kw)


def _migration_pair(paging, injector=None):
    rsim = _migration_fleet(Cluster, paging, injector).run(
        [JobSpec(name=n, profile=FRAG, n_iters=k, iter_time=IT, utilization=1.0)
         for n, k in SPECS])
    cex = _migration_fleet(ClusterExecutor, paging, injector, accounting="nominal", device="cpu")
    sessions = [_session(n, FRAG, k, IT) for n, k in SPECS]
    for s in sessions:
        cex.submit(s)
    return rsim, cex.run(), sessions


@pytest.mark.parametrize("paging", [False, True])
def test_migration_differential_cluster_vs_executor(paging):
    rsim, rex, sessions = _migration_pair(paging)
    assert rsim.migration_log(), "scenario must actually migrate"
    assert rsim.migration_log() == rex.migration_log()
    for d in range(3):
        assert rsim.device_results[d].decision_log == rex.device_reports[d].decision_log
    assert rsim.completed == rex.completed == len(SPECS)
    assert len(rex.migrations) == len([e for e in rex.migration_log() if e[0] == "migrate"])
    # the executor really moved each session's tensor and ran every step on it
    for s in sessions:
        assert torch.equal(s.state, torch.full((4,), float(s.n_iters)))
    moved = {m.name for m in rex.migrations}
    assert moved and all(rex.stats[s.job.job_id].migrations == (s.name in moved)
                         for s in sessions)


def test_migration_failure_parity_cluster_vs_executor():
    rsim, rex, sessions = _migration_pair(False, injector=[1])
    assert rsim.migration_log() == rex.migration_log()
    assert any(e[0] == "migrate_failed" for e in rsim.migration_log())
    assert rsim.completed == rex.completed == len(SPECS)
    for s in sessions:
        assert torch.equal(s.state, torch.full((4,), float(s.n_iters)))


def test_migration_differential_matches_jax_cluster():
    """The JAX package's ``Cluster`` on the same shape decides the same
    migrations as the port's (and so as the port's live fleet)."""
    jax_res = jax_core.Cluster(
        3, CAP, "srtf", strategy="least_loaded", memory=jax_core.MemoryConfig(paging=True),
        rebalancer=jax_core.Rebalancer(mode="consolidate"), rebalance_interval=0.02,
    ).run([jax_core.JobSpec(name=n, profile=jax_core.MemoryProfile(FRAG.persistent,
                                                                    FRAG.ephemeral),
                            n_iters=k, iter_time=IT, utilization=1.0) for n, k in SPECS])
    port_res = _migration_fleet(Cluster, True).run(
        [JobSpec(name=n, profile=FRAG, n_iters=k, iter_time=IT, utilization=1.0)
         for n, k in SPECS])
    assert result_view(jax_res) == result_view(port_res)


# ---------------------------------------------------------------------------
# launch counters under threads
# ---------------------------------------------------------------------------


def test_launch_counters_are_exact_under_threads():
    """16 threads (more than the cores) each count a few hundred launches
    on every wrapper at once, with the interpreter switching threads as
    often as it can: no count is lost."""
    counters = chip_smoke.kernel_counters()
    saved = {name: fn.launches for name, fn in counters.items()}
    chip_smoke.zero_counts(counters)
    n_threads, calls = 16, 300
    gate = threading.Barrier(n_threads, timeout=30.0)

    def work():
        gate.wait()
        for _ in range(calls):
            for fn in counters.values():
                _build.count_launch(fn)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
        counts = {name: fn.launches for name, fn in counters.items()}
        for name, fn in counters.items():
            fn.launches = saved[name]
    assert counts == dict.fromkeys(counters, n_threads * calls)


def test_launch_count_waits_for_the_counter_lock():
    """The increment is made under the counter lock: a thread counting a
    launch while the lock is held does not add until it is released."""
    fn = chip_smoke.kernel_counters()["rmsnorm"]
    before = fn.launches
    with _build._count_lock:
        t = threading.Thread(target=_build.count_launch, args=(fn,))
        t.start()
        t.join(0.2)
        assert t.is_alive() and fn.launches == before
    t.join(timeout=10.0)
    assert not t.is_alive() and fn.launches == before + 1
    fn.launches = before


# ---------------------------------------------------------------------------
# chip_smoke.py's fleet phase, on the CPU at smoke size
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chip_smoke_fleet_on_cpu(one_thread):
    """F1 (paging off and on), F2 and F3 with gemma-2b smoke sessions: the
    helpers' own checks (logs equal to the port's Cluster, a migration, a
    rolled-back failure, tokens bit for bit, threads and sequential
    identical in their nominal data) raise on a failure."""
    specs = chip_smoke.fleet_sessions(get_config("gemma-2b").smoke(), CPU)
    counters = chip_smoke.kernel_counters()
    runs = [chip_smoke.fleet_run(specs, CPU, paging, counters) for paging in (False, True)]
    failed = chip_smoke.fleet_run(specs, CPU, False, counters, fail_at=chip_smoke.FLEET_FAIL_AT)
    assert any(e[0] == "migrate_failed" for e in failed["migration_log"])
    seq = chip_smoke.fleet_run(specs, CPU, True, counters, concurrency="sequential")
    chip_smoke.fleet_nominal_equal(runs[1], seq)
    for r in (*runs, failed, seq):
        assert r["moves"] and all(m["out_gb"] > 0 and m["in_gb"] > 0 for m in r["moves"])
        assert r["iterations"] == sum(n for _, n in chip_smoke.FLEET_SPECS)
        # the CPU takes the plain versions: no kernel launches
        assert not any(r["launches"].values())
