"""Port executor vs the JAX package's simulator: under nominal accounting the
port's ``SalusExecutor`` takes exactly the decisions the JAX ``Simulator``
takes on the same seeded trace (tests/test_differential.py, rebuilt with
port sessions), with paging off and on. Plus an exact pager round trip
and failure isolation (tests/test_serving.py)."""
import time

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from repro.core import MemoryConfig as JaxMemoryConfig  # noqa: E402
from repro.core import Simulator  # noqa: E402
from repro.core import get_policy as jax_get_policy  # noqa: E402
from repro.core.tracegen import generate_trace, request_trace  # noqa: E402
from repro.core.types import JobSpec as JaxJobSpec  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GB,
    MB,
    MemoryConfig,
    MemoryProfile,
    SalusExecutor,
    Session,
    get_policy,
)

CPU = torch.device("cpu")
MEMCFG = dict(page_bandwidth=1e12)  # transfers modeled ~free, as in the JAX suite
SERVE_POOL = ["alexnet_25", "googlenet_25", "overfeat_25", "vgg11_25"]
SERVE_CAP = 450 * 1024 * 1024


def _sleep_step(seconds):
    def step(state, batch):
        time.sleep(seconds)  # stand-in for a real device iteration
        return state

    return step


def _port_session(job, name=None):
    """A port session carrying ``job``'s declared profile and timing."""
    return Session(
        name or job.name, _sleep_step(job.iter_time), torch.zeros(4), lambda i: None,
        job.n_iters, profile=MemoryProfile(job.profile.persistent, job.profile.ephemeral),
        iter_time=job.iter_time, utilization=job.utilization, arrival_time=0.0,
        kind=job.kind, request_times=job.request_times, device=CPU,
    )


def _run_port(jobs, policy, paging, cap):
    ex = SalusExecutor(
        cap, get_policy(policy), memory=MemoryConfig(paging=paging, **MEMCFG),
        accounting="nominal", device=CPU,
    )
    names = {}
    for j in jobs:
        sess = _port_session(j)
        names[sess.job.job_id] = j.name
        ex.submit(sess)
    rep = ex.run()
    recs = [(names[r.job_id], r.index) for r in rep.records]
    lats = {names[jid]: s.request_latencies for jid, s in rep.stats.items()}
    return rep, recs, lats


def _run_jax(jobs, policy, paging, cap):
    res = Simulator(
        cap, jax_get_policy(policy), memory=JaxMemoryConfig(paging=paging, **MEMCFG)
    ).run(jobs)
    names = {j.job_id: j.name for j in jobs}
    recs = [(names[r.job_id], r.index) for r in res.records]
    lats = {names[jid]: s.request_latencies for jid, s in res.stats.items()}
    return res, recs, lats


@pytest.mark.parametrize(
    "seed,paging", [(0, False), (1, False), (2, False), (0, True), (3, True), (4, True)]
)
def test_priority_openloop_matches_jax_simulator(seed, paging):
    jobs = request_trace(
        n_services=4, seed=seed, rps=4.0, duration=1.0, names=SERVE_POOL,
        train_background="vae_256", train_iters=30, iter_time_scale=0.05,
    )
    sres, srecs, slats = _run_jax(jobs, "priority", paging, SERVE_CAP)
    erep, erecs, elats = _run_port(jobs, "priority", paging, SERVE_CAP)
    assert erep.decision_log == sres.decision_log
    kinds = {k for k, *_ in sres.decision_log}
    assert kinds & {"queue", "second_chance", "page_out"}
    if paging:
        assert {"page_out", "page_in"} <= kinds
    assert erecs == srecs
    assert set(elats) == set(slats)
    for name in slats:
        assert elats[name] == pytest.approx(slats[name], abs=1e-9)


def _diff_jobs(seed, n_jobs=8, max_iters=5):
    """tests/test_differential.py's ``diff_specs``: ms-scale iterations,
    simultaneous arrivals, utilization 1.0."""
    return [
        JaxJobSpec(
            name=f"{i}:{j.name}", profile=j.profile,
            n_iters=max(2, min(j.n_iters, max_iters)),
            iter_time=round(min(max(j.iter_time * 0.02, 0.002), 0.02), 6),
            utilization=1.0, arrival_time=0.0,
        )
        for i, j in enumerate(generate_trace(n_jobs=n_jobs, seed=seed))
    ]


@pytest.mark.parametrize(
    "policy,seed,paging",
    [
        ("fifo", 0, False), ("fifo", 4, False), ("fifo", 7, False),
        ("fifo", 3, True), ("fifo", 5, True), ("fifo", 7, True),
        ("srtf", 1, False), ("srtf", 2, False), ("srtf", 9, False),
        ("srtf", 0, True), ("srtf", 8, True), ("srtf", 9, True),
    ],
)
def test_exclusive_policies_match_jax_simulator(policy, seed, paging):
    jobs = _diff_jobs(seed)
    sres, srecs, _ = _run_jax(jobs, policy, paging, 16 * GB)
    erep, erecs, _ = _run_port(jobs, policy, paging, 16 * GB)
    assert erep.decision_log == sres.decision_log
    assert erecs == srecs


def test_pager_round_trip_is_exact():
    """Submitting c pages a and b out to host and back; every value comes
    back bit for bit and each session finishes its own iterations."""
    ex = SalusExecutor(
        10 * GB, get_policy("fifo"), memory=MemoryConfig(paging=True, **MEMCFG), device=CPU
    )
    gen = torch.Generator().manual_seed(0)
    sessions, originals, before = {}, {}, {}
    for name, (p, e), iters in (("a", (3, 2), 4), ("b", (3, 2), 4), ("c", (1, 6), 2)):
        state = {"w": torch.randn(64, generator=gen), "n": torch.zeros((), dtype=torch.int64)}
        originals[name] = {k: v.clone() for k, v in state.items()}
        before[name] = state["w"].data_ptr()
        sessions[name] = Session(
            name, lambda s, b: {"w": s["w"], "n": s["n"] + 1}, state, lambda i: None, iters,
            profile=MemoryProfile(int(p * GB), int(e * GB)), iter_time=0.002, device=CPU,
        )
        ex.submit(sessions[name])
    # c's admission moved a's and b's tensors out: new host copies
    assert sessions["a"].state["w"].data_ptr() != before["a"]
    assert sessions["b"].state["w"].data_ptr() != before["b"]
    rep = ex.run()
    assert rep.registry_stats["page_outs"] >= 2 and rep.registry_stats["page_ins"] >= 2
    assert len(rep.transfer_latencies) >= 4 and all(t >= 0 for t in rep.transfer_latencies)
    for name, sess in sessions.items():
        assert sess.finished
        assert torch.equal(sess.state["w"], originals[name]["w"])
        assert int(sess.state["n"]) == sess.n_iters


def _session(name, step, n_iters, p_mb, e_mb, data_fn=lambda i: None):
    return Session(
        name, step, torch.zeros(4), data_fn, n_iters,
        profile=MemoryProfile(p_mb * MB, e_mb * MB), iter_time=0.002, device=CPU,
    )


def test_failing_session_is_isolated_and_frees_its_lane():
    ex = SalusExecutor(100 * MB, get_policy("fifo"), accounting="nominal", device=CPU)

    def bad_step(state, batch):
        raise RuntimeError("synthetic kernel crash")

    good_step = lambda s, b: s + 1.0
    bad = _session("bad", bad_step, 5, 10, 30)
    good = _session("good", good_step, 4, 10, 30)
    queued = _session("queued", good_step, 3, 10, 60)  # fits once a lane frees
    for s in (bad, good, queued):
        ex.submit(s)
    assert [j.name for j in ex.registry.queue] == ["queued"]
    rep = ex.run()
    assert list(rep.failures.values()) == ["RuntimeError: synthetic kernel crash"]
    assert rep.stats[bad.job.job_id].failed
    assert rep.stats[bad.job.job_id].iterations_done == 0
    assert good.finished and rep.stats[good.job.job_id].iterations_done == 4
    assert queued.finished
    assert bad.job.job_id not in ex.registry.assignment
    kinds = [(k, n) for k, _o, n, _l in rep.decision_log]
    assert ("second_chance", "queued") in kinds or ("admit", "queued") in kinds


def test_failure_in_data_fn_also_isolated():
    ex = SalusExecutor(100 * MB, get_policy("fifo"), accounting="nominal", device=CPU)
    step = lambda s, b: s + 1.0
    bad = _session("bad-data", step, 3, 10, 30,
                   data_fn=lambda i: (_ for _ in ()).throw(ValueError("bad batch")))
    ok = _session("ok", step, 2, 10, 30)
    ex.submit(bad)
    ex.submit(ok)
    rep = ex.run()
    assert "ValueError" in list(rep.failures.values())[0]
    assert ok.finished and not rep.stats[ok.job.job_id].failed


def test_executor_requires_a_device():
    with pytest.raises(TypeError):
        SalusExecutor(GB, get_policy("fifo"))


# ---------------------------------------------------------------------------
# two real training sessions sharing one device (ROADMAP queue A item 7)
# ---------------------------------------------------------------------------


def _trainer_pair(engine):
    """Two gemma-2b-smoke AdamW trainers, "A" and "B" (params from JAX
    seeds 1 and 2, SyntheticLM seeds 3 and 4), fp32 compute, as (name,
    step, state, data_fn) on the JAX package (``engine="jax"``) or the
    port."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jax_get_config
    from repro.data.pipeline import SyntheticLM as JaxSyntheticLM
    from repro.models import ModelOptions as JaxModelOptions
    from repro.models import build_model as jax_build_model
    from repro.train.optimizer import AdamW as JaxAdamW
    from repro.train.optimizer import AdamWConfig as JaxAdamWConfig
    from repro.train.train_step import make_train_step as jax_make_train_step
    from repro_torch.configs import get_config
    from repro_torch.models import ModelOptions, build_model
    from repro_torch.train.optimizer import AdamW, AdamWConfig
    from repro_torch.train.train_step import make_train_step
    from repro_torch.weights import from_jax

    opt_cfg = dict(lr=3e-4, warmup_steps=200, total_steps=50_000)
    jm = jax_build_model(jax_get_config("gemma-2b").smoke(),
                         JaxModelOptions(loss_chunk=8, compute_dtype="float32"))
    out = []
    for name, seed in (("A", 1), ("B", 2)):
        jparams = jm.init(jax.random.PRNGKey(seed))
        pipe = JaxSyntheticLM(256, 16, 4, seed=seed + 2)
        if engine == "jax":
            opt = JaxAdamW(JaxAdamWConfig(**opt_cfg))
            step = jax_make_train_step(jm, opt)
            state = (jparams, opt.init(jparams))
            data_fn = lambda i, pipe=pipe: {k: jnp.asarray(v) for k, v in pipe.batch(i).items()}
        else:
            model = build_model(get_config("gemma-2b").smoke(),
                                ModelOptions(loss_chunk=8, compute_dtype="float32"))
            opt = AdamW(AdamWConfig(**opt_cfg))
            step = make_train_step(model, opt)
            params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), CPU)
            state = (params, opt.init(params))
            data_fn = lambda i, pipe=pipe: {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}

        def session_step(st, batch, step=step):
            p, o, metrics = step(st[0], st[1], batch)
            return (p, o), metrics

        out.append((name, session_step, state, data_fn))
    return out


def test_two_training_sessions_share_a_device_like_jax():
    """FAIR, paging forced (the capacity holds one trainer's persistent
    state beside the shared lane, not both): each session's per-step
    losses match the same sessions on the JAX ``SalusExecutor`` (rtol
    1e-5), and the two decision logs are identical."""
    from repro.core import MemoryConfig as JaxMemoryConfig
    from repro.core import MemoryProfile as JaxMemoryProfile
    from repro.core import SalusExecutor as JaxSalusExecutor
    from repro.core import VirtualDevice as JaxVirtualDevice
    from repro.core import get_policy as jax_get_policy
    from repro_torch.core import VirtualDevice

    p_b, e_b, cap, iters = 40 * MB, 60 * MB, 130 * MB, 3
    runs = {}
    for engine in ("jax", "port"):
        if engine == "jax":
            ex = JaxSalusExecutor(cap, jax_get_policy("fair"),
                                  memory=JaxMemoryConfig(paging=True, **MEMCFG), accounting="nominal")
            vdev, prof = JaxVirtualDevice(ex), JaxMemoryProfile(p_b, e_b)
        else:
            ex = SalusExecutor(cap, get_policy("fair"), memory=MemoryConfig(paging=True, **MEMCFG),
                               accounting="nominal", device=CPU)
            vdev, prof = VirtualDevice(ex), MemoryProfile(p_b, e_b)
        sessions = [vdev.create_session(name, step, state, data_fn, n_iters=iters, profile=prof,
                                        iter_time=0.002)
                    for name, step, state, data_fn in _trainer_pair(engine)]
        rep = vdev.run()
        assert not rep.failures
        runs[engine] = (rep, {s.name: [float(m["loss"]) for m in s.metrics_log] for s in sessions})
    (jrep, jloss), (prep, ploss) = runs["jax"], runs["port"]
    kinds = {k for k, *_ in prep.decision_log}
    assert {"page_out", "page_in"} <= kinds
    assert prep.decision_log == jrep.decision_log
    assert set(ploss) == {"A", "B"}
    for name in ploss:
        assert len(ploss[name]) == iters
        np.testing.assert_allclose(ploss[name], jloss[name], rtol=1e-5)
