"""The port's live ``SalusExecutor`` against the port's own ``Simulator``
(twins of ``tests/test_differential.py``'s single-device tests), and
``chip_smoke.py``'s ``differential`` phase rehearsed on the CPU at smoke
size. Under ``accounting="nominal"`` both engines' decisions are pure
functions of the trace, so decision logs, lane assignments and iteration
orders are compared exactly; JCTs within the JAX suite's bands (the
executor really sleeps each iteration's declared time)."""
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GB,
    JobSpec,
    MemoryConfig,
    MemoryProfile,
    SalusExecutor,
    Session,
    Simulator,
    get_policy,
)
from repro_torch.core.tracegen import generate_trace, request_trace  # noqa: E402
from test_torch_core import CPU, MEMCFG, SERVE_CAP, SERVE_POOL, _port_session  # noqa: E402

import chip_smoke  # noqa: E402

CAP = 16 * GB


def diff_jobs(seed, n_jobs=8, max_iters=5):
    """``tests/test_differential.py``'s ``diff_specs`` from the port's
    tracegen: ms-scale iterations, simultaneous arrivals, utilization 1.0."""
    return [
        JobSpec(name=f"{i}:{j.name}", profile=j.profile, n_iters=max(2, min(j.n_iters, max_iters)),
                iter_time=round(min(max(j.iter_time * 0.02, 0.002), 0.02), 6),
                utilization=1.0, arrival_time=0.0)
        for i, j in enumerate(generate_trace(n_jobs=n_jobs, seed=seed))
    ]


def _named(res, names):
    recs = [(names[r.job_id], r.index, r.lane_id) for r in res.records]
    jcts = {names[j]: s.jct for j, s in res.stats.items() if s.jct is not None}
    lats = {names[j]: s.request_latencies for j, s in res.stats.items()}
    return recs, jcts, lats


def run_sim(jobs, policy, paging, cap=CAP):
    res = Simulator(cap, get_policy(policy), memory=MemoryConfig(paging=paging, **MEMCFG)).run(jobs)
    return (res, *_named(res, {j.job_id: j.name for j in jobs}))


def run_exec(jobs, policy, paging, cap=CAP):
    ex = SalusExecutor(cap, get_policy(policy), memory=MemoryConfig(paging=paging, **MEMCFG),
                       accounting="nominal", device=CPU)
    names = {}
    for j in jobs:
        sess = _port_session(j)
        names[sess.job.job_id] = j.name
        ex.submit(sess)
    rep = ex.run()
    return (rep, *_named(rep, names))


def per_lane(recs):
    lanes = {}
    for name, idx, lane in recs:
        lanes.setdefault(lane, []).append((name, idx))
    return lanes


def lane_assignment(decision_log):
    return {(o, name): lane for kind, o, name, lane in decision_log
            if kind in ("admit", "second_chance")}


def assert_jcts_close(sim_jcts, exec_jcts, factor):
    assert set(sim_jcts) == set(exec_jcts)
    for name, s in sim_jcts.items():
        e = exec_jcts[name]
        assert s / factor - 0.05 <= e <= s * factor + 0.1, (
            f"{name}: sim jct {s:.4f}s vs exec jct {e:.4f}s outside x{factor} band")


@pytest.mark.parametrize(
    "policy,seed,paging",
    [
        ("fifo", 0, False), ("fifo", 4, False), ("fifo", 7, False),
        ("fifo", 3, True), ("fifo", 5, True), ("fifo", 7, True),
        ("srtf", 1, False), ("srtf", 2, False), ("srtf", 9, False),
        ("srtf", 0, True), ("srtf", 8, True), ("srtf", 9, True),
    ],
)
def test_exclusive_policies_bitwise_identical(policy, seed, paging):
    sres, srecs, sjct, _ = run_sim(diff_jobs(seed), policy, paging)
    erep, erecs, ejct, _ = run_exec(diff_jobs(seed), policy, paging)
    assert sres.decision_log == erep.decision_log
    assert [(n, i) for n, i, _ in srecs] == [(n, i) for n, i, _ in erecs]
    assert per_lane(srecs) == per_lane(erecs)
    assert_jcts_close(sjct, ejct, factor=2.5)


@pytest.mark.parametrize("seed", [1, 2, 6, 8])
def test_pack_decisions_and_lane_order_identical(seed):
    sres, srecs, sjct, _ = run_sim(diff_jobs(seed), "pack", paging=False)
    erep, erecs, ejct, _ = run_exec(diff_jobs(seed), "pack", paging=False)
    assert sres.decision_log == erep.decision_log
    assert lane_assignment(sres.decision_log) == lane_assignment(erep.decision_log)
    assert per_lane(srecs) == per_lane(erecs)
    assert_jcts_close(sjct, ejct, factor=6.0)


@pytest.mark.parametrize("seed", [1, 2, 6, 8])
def test_fair_decisions_and_assignment_identical(seed):
    sres, srecs, sjct, _ = run_sim(diff_jobs(seed), "fair", paging=False)
    erep, erecs, ejct, _ = run_exec(diff_jobs(seed), "fair", paging=False)
    assert sres.decision_log == erep.decision_log
    assert lane_assignment(sres.decision_log) == lane_assignment(erep.decision_log)
    # within-lane order may differ (contention-scaled vs nominal service
    # clock); the iteration multiset and completion set must not
    assert sorted((n, i) for n, i, _ in srecs) == sorted((n, i) for n, i, _ in erecs)
    assert_jcts_close(sjct, ejct, factor=6.0)


def _gb_jobs(*specs):
    return [JobSpec(name=name, profile=MemoryProfile(int(p * GB), int(e * GB)), n_iters=n,
                    iter_time=0.004, utilization=1.0, arrival_time=0.0)
            for name, p, e, n in specs]


@pytest.mark.parametrize("policy", ["fifo", "srtf"])
def test_overcommit_completes_via_paging_in_both_engines(policy):
    """17 GB of demand on a 10 GB device: c is admitted only by paging a's
    and b's persistent regions out; they page back in after c drains."""
    mk = lambda: _gb_jobs(("a", 3, 2, 6), ("b", 3, 2, 6), ("c", 1, 6, 3))  # noqa: E731
    sres, srecs, sjct, _ = run_sim(mk(), policy, paging=True, cap=10 * GB)
    erep, erecs, ejct, _ = run_exec(mk(), policy, paging=True, cap=10 * GB)
    assert sres.decision_log == erep.decision_log
    assert [(n, i) for n, i, _ in srecs] == [(n, i) for n, i, _ in erecs]
    assert set(sjct) == set(ejct) == {"a", "b", "c"}
    for summary in (sres.summary(), dict(erep.registry_stats)):
        assert summary["rejected"] == 0
        assert summary["page_outs"] >= 2 and summary["page_ins"] >= 2
    kinds = [k for k, *_ in sres.decision_log]
    assert "page_out" in kinds and "page_in" in kinds
    assert_jcts_close(sjct, ejct, factor=2.5)


@pytest.mark.parametrize("policy", ["fifo", "srtf"])
def test_second_chance_readmission_identical(policy):
    mk = lambda: _gb_jobs(("res", 3, 2, 5), ("burst", 1, 9, 3))  # noqa: E731
    sres, srecs, sjct, _ = run_sim(mk(), policy, paging=False, cap=10 * GB)
    erep, erecs, ejct, _ = run_exec(mk(), policy, paging=False, cap=10 * GB)
    assert sres.decision_log == erep.decision_log
    assert ("second_chance", "burst") in [(k, n) for k, _o, n, _l in sres.decision_log]
    assert [(n, i) for n, i, _ in srecs] == [(n, i) for n, i, _ in erecs]
    assert set(sjct) == set(ejct) == {"res", "burst"}
    assert_jcts_close(sjct, ejct, factor=2.5)


def serve_trace(seed):
    return request_trace(
        n_services=4, seed=seed, rps=4.0, duration=1.0, names=SERVE_POOL,
        train_background="vae_256", train_iters=30, iter_time_scale=0.05,
    )


@pytest.mark.parametrize(
    "seed,paging", [(0, False), (1, False), (2, False), (0, True), (3, True), (4, True)]
)
def test_priority_openloop_differential(seed, paging):
    sres, srecs, _, slats = run_sim(serve_trace(seed), "priority", paging, cap=SERVE_CAP)
    erep, erecs, _, elats = run_exec(serve_trace(seed), "priority", paging, cap=SERVE_CAP)
    assert sres.decision_log == erep.decision_log
    kinds = {k for k, *_ in sres.decision_log}
    assert kinds & {"queue", "second_chance", "page_out"}
    if paging:
        assert {"page_out", "page_in"} <= kinds
    assert [(n, i) for n, i, _ in srecs] == [(n, i) for n, i, _ in erecs]
    assert set(slats) == set(elats)
    for name in slats:
        assert slats[name] == pytest.approx(elats[name], abs=1e-9)


def test_priority_openloop_inference_preempts_at_boundaries():
    jobs = serve_trace(0)
    sres = Simulator(SERVE_CAP, get_policy("priority"), memory=MemoryConfig(**MEMCFG)).run(jobs)
    train_id = [j.job_id for j in jobs if j.kind == "train"][0]
    assert sres.stats[train_id].preemptions > 0
    assert sres.stats[train_id].iterations_done == 30
    for j in jobs:
        if j.kind == "inference" and not sres.stats[j.job_id].rejected:
            assert sres.stats[j.job_id].iterations_done == j.n_iters


def test_executor_real_paging_moves_session_state():
    """The pager really moves the session's tensors: a paged-out state is
    a new host copy, and each session ends with its own values."""
    ex = SalusExecutor(10 * GB, get_policy("fifo"), memory=MemoryConfig(paging=True, **MEMCFG),
                       device=CPU)
    sessions, before = {}, {}
    for name, (p, e), iters in (("a", (3, 2), 4), ("b", (3, 2), 4), ("c", (1, 6), 2)):
        state = torch.zeros(16)
        before[name] = state.data_ptr()
        sessions[name] = Session(name, lambda s, b: s + 1.0, state, lambda i: None, iters,
                                 profile=MemoryProfile(int(p * GB), int(e * GB)),
                                 iter_time=0.002, device=CPU)
        ex.submit(sessions[name])
        del state
    assert sessions["a"].state.data_ptr() != before["a"]
    rep = ex.run()
    assert rep.registry_stats["page_outs"] >= 2
    assert rep.transfer_latencies and all(t >= 0 for t in rep.transfer_latencies)
    for sess in sessions.values():
        assert sess.finished
        assert torch.equal(sess.state, torch.full((16,), float(sess.n_iters)))


# ---------------------------------------------------------------------------
# chip_smoke.py's differential phase, on the CPU at smoke size
# ---------------------------------------------------------------------------


@pytest.fixture
def one_thread():
    """Smoke-size sessions spend most of their CPU starting and spinning
    the intra-op thread pool on tiny tensors; one thread runs them at a
    fraction of the cost, with the same results."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("policy", chip_smoke.DIFF_POLICIES)
def test_chip_smoke_closed_loop_on_cpu(policy, one_thread):
    """D1 with gemma-2b smoke sessions: the helper's own checks (decisions
    and lane order equal to the Simulator's, a page-out/page-in pair,
    tokens unchanged bit for bit) raise on a failure."""
    res = chip_smoke.differential_closed_loop(get_config("gemma-2b").smoke(), CPU, policy, {})
    assert {"page_out", "page_in"} <= {m["kind"] for m in res["page_moves"]}
    assert sum(len(v) for v in res["lanes"].values()) == sum(chip_smoke.DIFF_ITERS)


def test_chip_smoke_open_loop_on_cpu(one_thread):
    res = chip_smoke.differential_open_loop(get_config("gemma-2b").smoke(), True, CPU, {})
    assert res["requests"] > 0 and res["trainer_iterations"] == chip_smoke.DIFF_TRACE["train_iters"]
    assert len(res["latency_ms"]) == res["requests"]


# D1's byte shape: three equal sessions and a capacity of two and their
# lane. Round numbers, and the gemma-2b fp32 session's bytes as the card
# measured them (profile_step: 9.336 GiB persistent, 0.983 GiB ephemeral).
FAIR_SHAPES = {"round": (10 * GB, GB), "measured": (10024689664, 1055358976)}


@pytest.mark.parametrize("shape", sorted(FAIR_SHAPES))
def test_fair_page_delay_orders_match_jax_engines(shape):
    """D1's shape under paging and FAIR: the Simulator charges a page-in's
    modeled delay to the job's service, the nominal executor only the
    declared iteration time, so inside the lane the two engines resolve
    near ties apart. The JAX package's two engines do the same: each port
    engine's decisions and lane order equal its JAX twin's, the two
    engines agree on the lane's iterations (what the differential phase
    holds FAIR to) and, in both packages, not on their order."""
    import jax.numpy as jnp

    from repro.core import JobSpec as JaxJobSpec
    from repro.core import MemoryConfig as JaxMemoryConfig
    from repro.core import MemoryProfile as JaxMemoryProfile
    from repro.core import SalusExecutor as JaxSalusExecutor
    from repro.core import Simulator as JaxSimulator
    from repro.core import get_policy as jax_get_policy
    from repro.core.session import Session as JaxSession

    p, e = FAIR_SHAPES[shape]
    spec = list(zip(chip_smoke.DIFF_ITERS, chip_smoke.DIFF_ITER_TIMES))
    lanes = {}
    for pkg in ("jax", "port"):
        spec_cls, prof_cls, sim_cls, ex_cls, cfg_cls, pol = (
            (JaxJobSpec, JaxMemoryProfile, JaxSimulator, JaxSalusExecutor, JaxMemoryConfig,
             jax_get_policy) if pkg == "jax" else
            (JobSpec, MemoryProfile, Simulator, SalusExecutor, MemoryConfig, get_policy))
        jobs = [spec_cls(name=f"s{i}", profile=prof_cls(p, e), n_iters=n, iter_time=t)
                for i, (n, t) in enumerate(spec)]
        sim = sim_cls(2 * p + e, pol("fair"), memory=cfg_cls(paging=True)).run(jobs)
        kw = {} if pkg == "jax" else {"device": CPU}
        ex = ex_cls(2 * p + e, pol("fair"), memory=cfg_cls(paging=True), accounting="nominal",
                    **kw)
        names = {}
        for i, (n, t) in enumerate(spec):
            state = jnp.zeros(4) if pkg == "jax" else torch.zeros(4)
            sess = (JaxSession if pkg == "jax" else Session)(
                f"s{i}", lambda s, b: s, state, lambda k: None, n, profile=prof_cls(p, e),
                iter_time=t, **kw)
            names[sess.job.job_id] = sess.name
            ex.submit(sess)
        rep = ex.run()
        assert list(rep.decision_log) == list(sim.decision_log)
        assert {"page_out", "page_in"} <= {k for k, *_ in sim.decision_log}
        lanes[pkg] = (chip_smoke.lane_orders(sim.records, {j.job_id: j.name for j in jobs}),
                      chip_smoke.lane_orders(rep.records, names), list(sim.decision_log))
    assert lanes["port"] == lanes["jax"]
    for pkg in ("jax", "port"):
        sim_lanes, ex_lanes, _ = lanes[pkg]
        assert ({k: sorted(v) for k, v in sim_lanes.items()}
                == {k: sorted(v) for k, v in ex_lanes.items()})
        assert sim_lanes != ex_lanes, f"{pkg}: FAIR's lane orders no longer differ"
