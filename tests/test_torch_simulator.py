"""The port's discrete-event ``Simulator`` (``repro_torch.core.simulator``)
against the JAX package's on the CPU: the same traces, each package's from
its own generators with the same seed, give the same decision logs, the
same iteration records (job, index, lane, start, end) and the same JCTs,
exactly, paging off and on. Plus twins of the simulator-only scenarios of
``tests/test_paper_scenarios.py``."""
import itertools

import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

from repro.core import MemoryConfig as JaxMemoryConfig  # noqa: E402
from repro.core import Simulator as JaxSimulator  # noqa: E402
from repro.core import get_policy as jax_get_policy  # noqa: E402
from repro.core import tracegen as jax_tracegen  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GB,
    MB,
    JobSpec,
    LaneRegistry,
    MemoryConfig,
    MemoryProfile,
    Simulator,
    get_policy,
)
from repro_torch.core import tracegen  # noqa: E402
from repro_torch.core.profiles import PAPER_WORKLOADS  # noqa: E402

POLICIES = ["fifo", "srtf", "pack", "fair", "priority"]
# tests/test_differential.py's serving scenario: four mid-size services and
# a small background trainer on a 450 MB device
SERVE_POOL = ["alexnet_25", "googlenet_25", "overfeat_25", "vgg11_25"]
SERVE_CAP = 450 * 1024 * 1024
# a trace of heavier workloads whose own short durations keep it small
# enough to run uncapped
HEAVY = ["googlenet_100", "inception3_50", "resnet50_50", "resnet101_25", "vgg16_100",
         "speech_50", "seq2seq_large"]


def _outcome(res, jobs):
    """A run as plain values, jobs named by their place in the trace
    (generated traces repeat workload names)."""
    pos = {j.job_id: i for i, j in enumerate(jobs)}
    return {
        "log": list(res.decision_log),
        "records": [(pos[r.job_id], r.index, r.lane_id, r.start, r.end) for r in res.records],
        "jcts": {pos[jid]: s.jct for jid, s in res.stats.items()},
        "latencies": {pos[jid]: s.request_latencies for jid, s in res.stats.items()},
        "makespan": res.makespan,
        "summary": res.summary(),
    }


def _both(make, policy, paging, cap=16 * GB, until=None, cap_iters=None, **mem):
    """``make(module)`` builds the trace from either package's tracegen;
    both simulators run it. Returns (port outcome, JAX outcome)."""
    out = []
    for mod, sim, pol, cfg in ((tracegen, Simulator, get_policy, MemoryConfig),
                               (jax_tracegen, JaxSimulator, jax_get_policy, JaxMemoryConfig)):
        jobs = make(mod)
        if cap_iters is not None:
            for j in jobs:
                j.n_iters = min(j.n_iters, cap_iters)
        res = sim(cap, pol(policy), memory=cfg(paging=paging, **mem)).run(jobs, until=until)
        out.append(_outcome(res, jobs))
    return out


@pytest.mark.parametrize("paging", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("policy", POLICIES)
def test_generated_trace_matches_jax(policy, seed, paging):
    """24 jobs arriving 0.5 s apart on average (so they contend for the
    16 GB device), iterations capped at 40 a job."""
    ours, theirs = _both(lambda m: m.generate_trace(n_jobs=24, seed=seed, mean_interarrival=0.5),
                         policy, paging, cap_iters=40)
    assert ours == theirs
    kinds = {k for k, *_ in ours["log"]}
    assert "queue" in kinds
    if paging:
        assert {"page_out", "page_in"} <= kinds


@pytest.mark.parametrize("paging", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_uncapped_trace_matches_jax(policy, paging):
    """``generate_trace`` as it comes (no cap): 16 short runs of heavy
    workloads, 839 iterations in all."""
    ours, theirs = _both(
        lambda m: m.generate_trace(n_jobs=16, seed=3, mean_interarrival=2.0, short_frac=1.0,
                                   short_duration=5.0, names=HEAVY), policy, paging)
    assert ours == theirs
    assert len(ours["records"]) == 839
    assert "queue" in {k for k, *_ in ours["log"]}


@pytest.mark.parametrize("policy", ["srtf", "fair"])
def test_cluster_trace_until_matches_jax(policy):
    """A two-device fleet's trace on one device, stopped at a horizon
    while jobs are still running."""
    ours, theirs = _both(lambda m: m.cluster_trace(n_devices=2, jobs_per_device=12, seed=5,
                                                   mean_interarrival=1.0),
                         policy, paging=True, until=30.0, cap_iters=60)
    assert ours == theirs
    assert ours["makespan"] == 30.0
    assert any(j is None for j in ours["jcts"].values())


@pytest.mark.parametrize("paging", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_request_trace_priority_matches_jax(seed, paging):
    ours, theirs = _both(
        lambda m: m.request_trace(n_services=4, seed=seed, rps=4.0, duration=1.0,
                                  names=SERVE_POOL, train_background="vae_256", train_iters=30,
                                  iter_time_scale=0.05),
        "priority", paging, cap=SERVE_CAP, page_bandwidth=1e12)
    assert ours == theirs
    assert sum(len(v) for v in ours["latencies"].values()) > 0
    kinds = {k for k, *_ in ours["log"]}
    assert kinds & {"queue", "second_chance", "page_out"}


# ---------------------------------------------------------------------------
# twins of tests/test_paper_scenarios.py (Simulator and tables only)
# ---------------------------------------------------------------------------


def test_fig6_progressive_allocation_deadlock_prevented():
    reg = LaneRegistry(12 * GB)
    a = JobSpec("A", MemoryProfile(1 * GB, 7 * GB), n_iters=10, iter_time=0.1)
    b = JobSpec("B", MemoryProfile(1 * GB, 7 * GB), n_iters=10, iter_time=0.1)
    lane_a = reg.job_arrive(a)
    lane_b = reg.job_arrive(b)
    assert lane_a is not None and lane_b is not None
    assert lane_a is lane_b
    assert reg.persistent_used + reg.lane_total == 9 * GB
    reg.check_invariants()
    jobs = [
        JobSpec("A", MemoryProfile(1 * GB, 7 * GB), n_iters=5, iter_time=0.1),
        JobSpec("B", MemoryProfile(1 * GB, 7 * GB), n_iters=5, iter_time=0.1),
    ]
    res = Simulator(12 * GB, get_policy("fair")).run(jobs)
    assert all(s.iterations_done == 5 for s in res.stats.values())


def test_obs2_persistent_smaller_than_ephemeral():
    for name, (p, e, _, _) in PAPER_WORKLOADS.items():
        assert p < e or name.startswith("vae"), f"{name}: P={p} E={e}"
    vals = list(PAPER_WORKLOADS.values())
    fits = sum(
        (a[0] + b[0] + max(a[1], b[1])) * MB <= 16 * GB
        for a, b in itertools.combinations(vals, 2)
    )
    total = len(vals) * (len(vals) - 1) // 2
    assert fits / total > 0.95


def test_switch_overhead_model_gandiva_vs_salus():
    def mk():
        return [
            JobSpec("long", MemoryProfile(500 * MB, 4 * GB), n_iters=60, iter_time=0.5),
            JobSpec("short", MemoryProfile(200 * MB, 2 * GB), n_iters=10,
                    iter_time=0.5, arrival_time=3.0),
        ]

    salus = Simulator(16 * GB, get_policy("srtf"), switch_overhead=0.01).run(mk())
    gandiva = Simulator(16 * GB, get_policy("srtf"), switch_overhead=1.0).run(mk())
    assert salus.avg_jct < gandiva.avg_jct
    short_s = [v for k, v in salus.stats.items() if salus.jobs[k].name == "short"][0]
    short_g = [v for k, v in gandiva.stats.items() if gandiva.jobs[k].name == "short"][0]
    assert short_s.jct < short_g.jct
