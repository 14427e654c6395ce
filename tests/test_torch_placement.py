"""The port's placement layer (``repro_torch.core.placement``) against the
JAX package's, on the CPU: twins of ``tests/test_cluster.py`` (placement
strategies, the cluster-level queue and retry, rejection, capacities,
``cluster_trace`` and ``ClusterResult``), of ``tests/test_migration.py``'s
``Rebalancer`` unit tests (the same hand-built views, the same
decisions), and of ``tests/test_fleet_events.py``'s check of the
``_LeastLoadedIndex`` heap against a linear scan. Each twin runs the JAX
test's scenario in both packages, holds the two plans (or results)
equal, and asserts the JAX test's own claims on the port. Placement does
no floating-point work that could differ between the packages, so every
comparison is exact; job ids differ (each package counts its own), so
plans are compared by job name."""
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import repro.core as jax_core  # noqa: E402
import repro.core.placement as jax_placement  # noqa: E402
import repro.core.tracegen as jax_tracegen  # noqa: E402
import repro_torch.core as port_core  # noqa: E402
import repro_torch.core.placement as port_placement  # noqa: E402
import repro_torch.core.tracegen as port_tracegen  # noqa: E402


def _pkg(core, placement, tracegen):
    ns = SimpleNamespace(**{name: getattr(core, name) for name in core.__all__})
    ns.placement = placement
    ns.cluster_trace = tracegen.cluster_trace
    ns.generate_trace = tracegen.generate_trace
    return ns


JAX = _pkg(jax_core, jax_placement, jax_tracegen)
PORT = _pkg(port_core, port_placement, port_tracegen)


def job(m, name, p_gb, e_gb, n_iters=10, iter_time=1.0, arrival=0.0, util=0.9):
    return m.JobSpec(name=name, profile=m.MemoryProfile(int(p_gb * m.GB), int(e_gb * m.GB)),
                     n_iters=n_iters, iter_time=iter_time, arrival_time=arrival,
                     utilization=util)


def plan_view(plan, jobs):
    """A plan by job name: its decision log, assignments and rejections."""
    names = {j.job_id: j.name for j in jobs}
    return (plan.decision_log(), {names[j]: d for j, d in plan.assignments.items()},
            sorted(names[j] for j in plan.rejected))


def result_view(res):
    """A ``ClusterResult`` by job name: placement and migration logs, every
    device's decision log, the iteration records and each job's stats."""
    names = {j: s.name for j, s in res.jobs.items()}
    return (res.placement_log(), res.migration_log(),
            [list(r.decision_log) for r in res.device_results],
            sorted((names[r.job_id], r.index, r.start, r.end, r.lane_id) for r in res.records),
            {names[j]: (st.iterations_done, st.finish_time, st.rejected, st.migrations,
                        st.transfer_time) for j, st in res.stats.items()},
            res.makespan, res.devices_used, res.summary())


def twin(scenario):
    """Run ``scenario(m)`` on the JAX package and on the port; return the
    port's outcome after holding the two views equal."""
    jax_out, port_out = scenario(JAX), scenario(PORT)
    assert jax_out[0] == port_out[0]
    return port_out[1]


# ---------------------------------------------------------------------------
# twins of tests/test_cluster.py
# ---------------------------------------------------------------------------


def test_get_strategy_accepts_names_and_enums():
    P = PORT
    assert P.get_strategy("best_fit") is P.PlacementStrategy.BEST_FIT
    assert P.get_strategy(P.PlacementStrategy.CONSOLIDATE) is P.PlacementStrategy.CONSOLIDATE
    with pytest.raises(KeyError):
        P.get_strategy("round_robin")
    assert ([s.value for s in P.PlacementStrategy] == [s.value for s in JAX.PlacementStrategy])
    assert ([k.value for k in P.PlacementEventKind] == [k.value for k in JAX.PlacementEventKind])


def test_least_loaded_spreads_best_fit_and_consolidate_pack():
    for strat in ("least_loaded", "best_fit", "consolidate"):
        def scenario(m):
            jobs = [job(m, f"j{i}", 0.5, 1.0) for i in range(4)]
            plan = m.Placer(4, 16 * m.GB, strat).place(jobs)
            return plan_view(plan, jobs), plan

        plan = twin(scenario)
        if strat == "least_loaded":
            assert sorted(plan.assignments.values()) == [0, 1, 2, 3]
        else:
            assert set(plan.assignments.values()) == {0}, strat


def test_best_fit_prefers_tightest_byte_fit():
    for strat in ("best_fit", "least_loaded"):
        def scenario(m):
            jobs = [job(m, "big", 1.0, 6.0), job(m, "small", 1.0, 1.0)]
            plan = m.Placer(2, 10 * m.GB, strat).place(jobs)
            return plan_view(plan, jobs), [plan.assignments[j.job_id] for j in jobs]

        assert twin(scenario) == ([0, 0] if strat == "best_fit" else [0, 1])


def test_consolidate_keeps_whole_devices_free():
    for strat, used in (("consolidate", 1), ("least_loaded", 4)):
        def scenario(m):
            res = m.Cluster(4, 16 * m.GB, "srtf", strategy=strat).run(
                [job(m, f"j{i}", 0.2, 0.8, n_iters=5) for i in range(6)])
            return result_view(res), res

        res = twin(scenario)
        assert res.devices_used == used and res.completed == 6


def test_cluster_queue_and_retry_deficit_ordered():
    def scenario(m):
        jobs = [job(m, "res", 1.0, 8.0, n_iters=5, iter_time=1.0, arrival=0.0),
                job(m, "b", 0.5, 9.0, arrival=1.0), job(m, "s", 1.5, 8.5, arrival=2.0)]
        plan = m.Placer(1, 10 * m.GB, "least_loaded").place(jobs)
        return plan_view(plan, jobs), plan

    plan = twin(scenario)
    K = PORT.PlacementEventKind
    kinds = [(e.kind, e.name) for e in plan.events]
    assert (K.QUEUE, "b") in kinds and (K.QUEUE, "s") in kinds
    assert [e.name for e in plan.events if e.kind is K.SECOND_CHANCE] == ["s", "b"]
    assert len(plan.assignments) == 3


@pytest.mark.parametrize("strat", ["least_loaded", "best_fit", "consolidate"])
def test_placed_or_queued_or_rejected_exactly_once(strat):
    K = PORT.PlacementEventKind
    for seed in (0, 1, 2):
        def scenario(m):
            jobs = m.generate_trace(n_jobs=30, seed=seed, mean_interarrival=20.0)
            return plan_view(m.Placer(3, 16 * m.GB, strat).place(jobs), jobs), (
                m.Placer(3, 16 * m.GB, strat).place(jobs), jobs)

        plan, jobs = twin(scenario)
        terminal, queued = {}, set()
        for e in plan.events:
            if e.kind is K.QUEUE:
                queued.add(e.ordinal)
                continue
            assert e.ordinal not in terminal, (strat, seed, e)
            terminal[e.ordinal] = e.kind
        assert len(terminal) == len(jobs)
        assert all(terminal[o] is K.SECOND_CHANCE for o in queued)
        assert set(plan.assignments) | plan.rejected == {j.job_id for j in jobs}
        assert not set(plan.assignments) & plan.rejected


def test_no_device_overcommit_at_admission():
    def scenario(m):
        jobs = m.generate_trace(n_jobs=40, seed=5, mean_interarrival=10.0)
        cluster = m.Cluster(3, 16 * m.GB, "srtf", strategy="best_fit")
        res = cluster.run(jobs)  # a SafetyViolation would propagate
        return result_view(res), (res, cluster, jobs)

    res, cluster, jobs = twin(scenario)
    for j in jobs:
        dev = res.plan.assignments.get(j.job_id)
        if dev is not None:
            assert j.profile.total <= cluster.placer.capacities[dev]
    assert res.completed == len(jobs) - len(res.plan.rejected)


def test_infeasible_job_rejected_once_and_in_engine():
    def scenario(m):
        jobs = [job(m, "toobig", 4.0, 14.0), job(m, "ok", 1.0, 2.0)]
        res = m.Cluster(2, 16 * m.GB, "fifo", strategy="least_loaded").run(jobs)
        return result_view(res), (res, jobs[0])

    res, toobig = twin(scenario)
    assert res.plan.rejected == {toobig.job_id}
    rejects = [e for e in res.plan.events if e.kind is PORT.PlacementEventKind.REJECT]
    assert [e.name for e in rejects] == ["toobig"]
    assert res.stats[toobig.job_id].rejected and res.stats[toobig.job_id].finish_time is None
    assert res.summary()["rejected"] == 1 and res.summary()["completed"] == 1


@pytest.mark.parametrize("strat", ["least_loaded", "best_fit", "consolidate"])
def test_heterogeneous_capacities_route_big_jobs(strat):
    def scenario(m):
        jobs = [job(m, "big", 2.0, 10.0)]
        plan = m.Placer(2, [8 * m.GB, 16 * m.GB], strat).place(jobs)
        return plan_view(plan, jobs), plan.assignments[jobs[0].job_id]

    assert twin(scenario) == 1


def test_placer_validates_arguments():
    for m in (JAX, PORT):
        with pytest.raises(ValueError):
            m.Placer(0, 16 * m.GB)
        with pytest.raises(ValueError):
            m.Placer(2, [16 * m.GB])


def _trace_key(jobs):
    return [(j.name, j.arrival_time, j.n_iters) for j in jobs]


def test_cluster_trace_is_deterministic_and_scales():
    a = PORT.cluster_trace(4, jobs_per_device=10, seed=9)
    assert _trace_key(a) == _trace_key(PORT.cluster_trace(4, jobs_per_device=10, seed=9))
    assert _trace_key(a) == _trace_key(JAX.cluster_trace(4, jobs_per_device=10, seed=9))
    assert len(a) == 40
    solo = PORT.cluster_trace(1, jobs_per_device=10, seed=9)
    assert len(solo) == 10
    assert max(j.arrival_time for j in a) < 2.5 * max(j.arrival_time for j in solo)
    with pytest.raises(ValueError):
        PORT.cluster_trace(0)


def test_cluster_trace_n1_equals_generate_trace():
    one = PORT.cluster_trace(1, jobs_per_device=15, seed=3)
    assert _trace_key(one) == _trace_key(PORT.generate_trace(n_jobs=15, seed=3))
    assert _trace_key(one) == _trace_key(JAX.cluster_trace(1, jobs_per_device=15, seed=3))


def test_cluster_result_aggregates_fleet_jcts():
    def scenario(m):
        jobs = [job(m, f"j{i}", 0.5, 1.0, n_iters=5, iter_time=1.0) for i in range(8)]
        res = m.Cluster(2, 16 * m.GB, "fifo", strategy="least_loaded").run(jobs)
        return (result_view(res), res.jcts, res.avg_jct, res.p95_jct,
                res.per_device_utilization), res

    res = twin(scenario)
    assert res.completed == 8 and len(res.jcts) == 8
    assert res.avg_jct == pytest.approx(sum(res.jcts) / 8)
    assert res.p95_jct == PORT.percentile(res.jcts, 0.95)
    assert res.makespan == max(r.makespan for r in res.device_results)
    utils = res.per_device_utilization
    assert len(utils) == 2 and all(0.0 <= u <= 1.0 + 1e-9 for u in utils)
    s = res.summary()
    assert s["n_devices"] == 2 and s["n_jobs"] == 8 and s["placed"] == 8
    assert len(res.placement_log()) == 8


def test_cluster_until_clamps_every_device():
    def scenario(m):
        jobs = m.generate_trace(n_jobs=12, seed=2, mean_interarrival=30.0)
        res = m.Cluster(2, 16 * m.GB, "srtf").run(jobs, until=200.0)
        return result_view(res), res

    res = twin(scenario)
    assert res.makespan <= 200.0
    for r in res.device_results:
        assert r.makespan <= 200.0 and all(rec.end <= 200.0 for rec in r.records)


def test_cluster_sharing_beats_fifo_exclusive_fleet():
    out = {}
    for policy in ("fifo", "srtf"):
        def scenario(m):
            res = m.Cluster(4, 16 * m.GB, policy).run(m.cluster_trace(4, jobs_per_device=5, seed=42))
            return result_view(res), res

        out[policy] = twin(scenario)
    assert out["fifo"].completed == out["srtf"].completed == 20
    assert out["fifo"].avg_jct / out["srtf"].avg_jct > 1.0


# ---------------------------------------------------------------------------
# twins of tests/test_migration.py's Rebalancer unit tests
# ---------------------------------------------------------------------------


def view(m, device_id, specs, dilation=1.0, sigma=0.0, **jv_kw):
    """Hand-built DeviceView: every spec is resident on a fresh registry."""
    cap = int(16 * m.GB)
    reg = m.LaneRegistry(cap)
    jvs = []
    for s in specs:
        assert reg.job_arrive(s) is not None
        jvs.append(m.JobView(s, **jv_kw))
    return m.DeviceView(device_id, cap, reg, jvs, dilation, sigma)


def decide(build, **rebalancer_kw):
    """The decisions of ``Rebalancer(**rebalancer_kw)`` on the views
    ``build(m)`` makes, in both packages, held equal."""
    out = [[(d.name, d.src, d.dst, d.reason)
            for d in m.Rebalancer(**rebalancer_kw).decide(build(m))] for m in (JAX, PORT)]
    assert out[0] == out[1]
    return out[1]


def test_consolidate_evacuates_cheapest_source():
    migs = decide(lambda m: [view(m, 0, [job(m, "longA", 2.4, 4.0, n_iters=100, util=0.4)]),
                             view(m, 1, [job(m, "shortB", 2.4, 4.0, n_iters=10, util=0.4)]),
                             view(m, 2, [])], mode="consolidate")
    assert migs == [("shortB", 1, 0, "consolidate")]


def test_consolidate_is_all_or_nothing():
    def anchor(m):
        return view(m, 0, [job(m, "anchor", 4.0, 5.0, n_iters=1000, util=0.4)])

    single = decide(lambda m: [anchor(m), view(m, 1, [job(m, "X", 2.4, 4.0, util=0.4)])],
                    mode="consolidate")
    assert single != []
    both = decide(lambda m: [anchor(m), view(m, 1, [job(m, "X", 2.4, 4.0, util=0.4),
                                                   job(m, "Y", 2.4, 4.0, util=0.4)])],
                  mode="consolidate")
    assert both == []


def test_consolidate_skips_immovable_and_finished_sources():
    def build(m):
        return [view(m, 0, [job(m, "pinned", 2.4, 4.0, n_iters=100)], done=99),
                view(m, 1, [job(m, "running", 2.4, 4.0, n_iters=100)], movable=False)]

    assert decide(build, mode="consolidate", min_remaining_iters=2) == []


def test_drain_bypasses_eligibility_caps():
    migs = decide(lambda m: [view(m, 0, [job(m, "sticky", 2.4, 4.0)], done=9, migrations=3),
                             view(m, 1, [])], mode="none", drain=(0,))
    assert migs == [("sticky", 0, 1, "drain")]
    migs = decide(lambda m: [view(m, 0, [job(m, "a", 2.4, 4.0)]),
                             view(m, 1, [job(m, "b", 2.4, 4.0)])], mode="consolidate", drain=(0,))
    assert all(dst != 0 for _, _, dst, _ in migs) and any(src == 0 for _, src, _, _ in migs)


def test_rebalance_respects_imbalance_threshold():
    near = decide(lambda m: [view(m, 0, [job(m, "a", 1.6, 2.4, n_iters=100)]),
                             view(m, 1, [job(m, "b", 1.6, 2.4, n_iters=90)])],
                  mode="rebalance", imbalance_threshold=0.25)
    assert near == []
    skew = decide(lambda m: [view(m, 0, [job(m, f"a{i}", 1.6, 2.4, n_iters=100)
                                         for i in range(3)]), view(m, 1, [])],
                  mode="rebalance", imbalance_threshold=0.25)
    assert skew and all(s == 0 and d == 1 and r == "rebalance" for _, s, d, r in skew)


def test_rebalance_caps_per_job_migrations():
    migs = decide(lambda m: [view(m, 0, [job(m, f"a{i}", 1.6, 2.4, n_iters=100)
                                         for i in range(3)], migrations=3), view(m, 1, [])],
                  mode="rebalance", max_migrations_per_job=3)
    assert migs == []


def test_rebalance_telemetry_damping_does_not_overshoot():
    migs = decide(lambda m: [view(m, 0, [job(m, f"t{i}", 1.6, 2.4, n_iters=100, util=0.6)
                                         for i in range(4)], dilation=2.4),
                             view(m, 1, [], dilation=1.0)], mode="rebalance", use_telemetry=True)
    assert len(migs) == 2 and all(s == 0 and d == 1 for _, s, d, _ in migs)


def test_rebalancer_rejects_bad_config():
    P = PORT
    with pytest.raises(ValueError):
        P.Rebalancer(mode="sideways")
    with pytest.raises(ValueError):
        P.Rebalancer(imbalance_threshold=-0.1)
    with pytest.raises(ValueError):
        P.Cluster(2, 16 * P.GB, "srtf", rebalance_interval=0.0)
    with pytest.raises(ValueError):
        P.Cluster(2, 16 * P.GB, "srtf", rebalancer=P.Rebalancer())  # no interval


# ---------------------------------------------------------------------------
# twin of tests/test_fleet_events.py: the heap index against a linear scan
# ---------------------------------------------------------------------------


class _ScanIndex:
    """The documented reference: min over admitting devices keyed on
    (outstanding seconds, device_id), the O(n) scan the heap replaced."""

    def __init__(self, devices):
        self._devices = devices

    def choose(self, job, now):
        fits = [d for d in self._devices if d.admits(job)]
        if not fits:
            return None
        return min(fits, key=lambda d: (d.outstanding(now), d.device_id))

    def placed(self, dev):
        pass


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_least_loaded_index_equals_linear_scan(seed, monkeypatch):
    cap = 16 * PORT.GB
    jobs = PORT.generate_trace(n_jobs=200, seed=seed, mean_interarrival=3.0)
    jax_jobs = JAX.generate_trace(n_jobs=200, seed=seed, mean_interarrival=3.0)
    fast = port_placement.Placer(8, cap, "least_loaded").place(jobs)
    jax_fast = jax_placement.Placer(8, cap, "least_loaded").place(jax_jobs)
    monkeypatch.setattr(port_placement, "_LeastLoadedIndex", _ScanIndex)
    slow = port_placement.Placer(8, cap, "least_loaded").place(jobs)
    assert fast.decision_log() == slow.decision_log()
    assert fast.assignments == slow.assignments and fast.rejected == slow.rejected
    assert plan_view(fast, jobs) == plan_view(jax_fast, jax_jobs)
