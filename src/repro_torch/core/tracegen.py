"""Job-trace generation following the paper's §5.1 methodology: 100 jobs
drawn from the Table-3 workload pool with multiple batch sizes, durations
following a production-cluster-like heavy-tailed distribution (most jobs
are short exploratory runs, a few are long trainings — the Gandiva/
Microsoft-trace shape the paper references), Poisson arrivals.
Deterministic in the seed.

The port's copy of the JAX package's ``core/tracegen.py``: every generator
draws from ``random.Random`` (``diurnal_trace`` from numpy's
``default_rng``) exactly as the JAX package's does, so both packages give
the same traces from the same seed.
"""
from __future__ import annotations

import math
import random
from typing import List, Optional

from repro_torch.core.profiles import PAPER_WORKLOADS, inference_profile, paper_job
from repro_torch.core.types import GB, MB, JobSpec, MemoryProfile

# Low-utilization models dominate packed serving (paper §5.3): these are the
# default service pool for open-loop request traces.
SERVING_POOL = (
    "vae_64",
    "superres_32",
    "vae_128",
    "superres_64",
    "vae_256",
    "superres_128",
)


def generate_trace(
    n_jobs: int = 100,
    seed: int = 42,
    mean_interarrival: float = 120.0,
    short_frac: float = 0.7,
    short_duration: float = 90.0,
    long_duration: float = 2700.0,
    names: Optional[List[str]] = None,
) -> List[JobSpec]:
    """Durations: mixture of exponentials (short exploratory vs long
    training), truncated; n_iters derived from the workload's iteration
    time so short jobs of a slow model still run >= 5 iterations."""
    rng = random.Random(seed)
    pool = names or sorted(PAPER_WORKLOADS)
    jobs: List[JobSpec] = []
    t = 0.0
    for i in range(n_jobs):
        t += rng.expovariate(1.0 / mean_interarrival)
        name = rng.choice(pool)
        if rng.random() < short_frac:
            duration = rng.expovariate(1.0 / short_duration) + 10.0
        else:
            duration = rng.expovariate(1.0 / long_duration) + 300.0
        iter_time = PAPER_WORKLOADS[name][2]
        n_iters = max(5, int(duration / iter_time))
        jobs.append(paper_job(name, n_iters=n_iters, arrival_time=t))
    return jobs


def cluster_trace(
    n_devices: int = 4,
    jobs_per_device: int = 25,
    seed: int = 42,
    mean_interarrival: float = 120.0,
    short_frac: float = 0.7,
    short_duration: float = 90.0,
    long_duration: float = 2700.0,
    names: Optional[List[str]] = None,
) -> List[JobSpec]:
    """Table-2-style mixed trace scaled to an ``n_devices`` fleet (paper
    §5.1 cluster regime): ``n_devices * jobs_per_device`` jobs from the
    same heavy-tailed duration mixture, with the Poisson arrival rate
    scaled linearly in the fleet size — a bigger cluster serves
    proportionally more submissions, so per-device pressure stays in the
    single-GPU regime the Fig. 5/6 comparison assumes. Deterministic in
    the seed; an N=1 trace is exactly ``generate_trace``'s."""
    if n_devices < 1:
        raise ValueError(f"n_devices must be >= 1, got {n_devices}")
    return generate_trace(
        n_jobs=n_devices * jobs_per_device,
        seed=seed,
        mean_interarrival=mean_interarrival / n_devices,
        short_frac=short_frac,
        short_duration=short_duration,
        long_duration=long_duration,
        names=names,
    )


def poisson_arrivals(rps: float, duration: float, rng: random.Random) -> List[float]:
    """Poisson arrival times over [0, duration); an idle stream still gets
    one probe request. Shared by ``request_trace`` and the live serve
    driver so both generate identical streams from the same rng."""
    times: List[float] = []
    t = rng.expovariate(rps)
    while t < duration:
        times.append(t)
        t += rng.expovariate(rps)
    if not times:
        times.append(rng.uniform(0.0, duration))
    return times


def request_trace(
    n_services: int = 3,
    seed: int = 0,
    rps: float = 2.0,
    duration: float = 30.0,
    names: Optional[List[str]] = None,
    train_background: Optional[str] = None,
    train_iters: Optional[int] = None,
    iter_time_scale: float = 1.0,
) -> List[JobSpec]:
    """Open-loop serving trace (paper §5.3, Fig. 9/10): ``n_services``
    inference services, each receiving a Poisson request stream of rate
    ``rps`` over ``[0, duration)``, optionally co-located with one
    best-effort background training job that PRIORITY preempts at iteration
    boundaries. An inference job's "iterations" are its requests: they
    queue until their arrival time passes instead of being always ready.

    Deterministic in the seed. Services round-robin over ``names`` (default
    ``SERVING_POOL``) so a small pool still yields distinct co-residents;
    per-request service time and the inference memory profile come from
    ``profiles.inference_profile``. ``iter_time_scale`` time-dilates the
    whole trace — iteration times AND request arrivals — so a ms-scale
    replica keeps the same load factor (the differential suite runs those
    live). ``train_iters`` bounds the background job (default: enough
    iterations to span the window).
    """
    rng = random.Random(seed)
    pool = list(names or SERVING_POOL)
    jobs: List[JobSpec] = []
    for i in range(n_services):
        name = pool[i % len(pool)]
        prof, req_time = inference_profile(name)
        times = poisson_arrivals(rps, duration, rng)
        _, _, _, u = PAPER_WORKLOADS[name]
        jobs.append(
            JobSpec(
                name=f"svc{i}:{name}",
                profile=prof,
                n_iters=len(times),
                iter_time=round(req_time * iter_time_scale, 9),
                utilization=max(0.05, u * 0.25),
                arrival_time=0.0,
                kind="inference",
                request_times=tuple(round(x * iter_time_scale, 9) for x in times),
            )
        )
    if train_background is not None:
        p, e, t, u = PAPER_WORKLOADS[train_background]
        iter_time = t * iter_time_scale
        n_iters = train_iters or max(5, int(math.ceil(duration / iter_time)))
        job = paper_job(train_background, n_iters=n_iters, arrival_time=0.0)
        job.iter_time = round(iter_time, 9)
        job.name = f"train:{train_background}"
        jobs.append(job)
    return jobs


def churn_trace(
    n_devices: int = 3,
    seed: int = 42,
    capacity: int = 16 * GB,
    pairs: Optional[int] = None,
    iter_time: float = 1.0,
    long_iters: int = 2000,
    short_iters: int = 150,
    big_arrival: float = 300.0,
    big_iters: int = 50,
) -> List[JobSpec]:
    """Fragmentation-by-churn trace for the migration/defrag benchmarks.

    ``pairs`` (default ``n_devices - 1``) long jobs plus as many short
    churn jobs arrive at t=0, emitted as ``long0, short..., long...`` —
    the order matters because arrival placement is submission-order
    sensitive: consolidate packs ``long0`` and the shorts together (a
    frag job is P+E = 0.4 C), leaving each remaining long straggler
    *alone* on its own device. When the shorts drain, the fleet is
    fragmented: stragglers spread one per device, none leaving room for
    the late ``big`` job (P+E ≈ 0.94 C) — so arrival-only placement must
    open a fresh device for it. A consolidate rebalance pass instead
    merges the stragglers onto fewer devices and the boundary
    re-placement amendment lands ``big`` on a freed (already-used) one,
    shrinking ``devices_used`` — the defrag-by-migration headline the
    migration benchmark measures.

    Deterministic in the seed (only iteration-count jitter is random).
    Defaults are tuned for ``rebalance_interval`` between the short jobs'
    drain (~``short_iters * iter_time``) and ``big_arrival``.
    """
    if n_devices < 2:
        raise ValueError(f"churn_trace needs >= 2 devices, got {n_devices}")
    rng = random.Random(seed)
    frag = MemoryProfile(int(0.15 * capacity), int(0.25 * capacity))
    big = MemoryProfile(int(0.375 * capacity), int(0.5625 * capacity))
    pairs = max(1, n_devices - 1) if pairs is None else pairs

    def long_job(i: int) -> JobSpec:
        return JobSpec(
            name=f"long{i}",
            profile=frag,
            n_iters=long_iters + rng.randrange(0, long_iters // 10 + 1),
            iter_time=iter_time,
            utilization=0.4,
            arrival_time=0.0,
        )

    def short_job(i: int) -> JobSpec:
        return JobSpec(
            name=f"short{i}",
            profile=frag,
            n_iters=max(5, short_iters - rng.randrange(0, short_iters // 5 + 1)),
            iter_time=iter_time,
            utilization=0.4,
            arrival_time=0.0,
        )

    jobs: List[JobSpec] = [long_job(0)]
    jobs.extend(short_job(i) for i in range(pairs))
    jobs.extend(long_job(i) for i in range(1, pairs))
    jobs.append(
        JobSpec(
            name="big",
            profile=big,
            n_iters=big_iters,
            iter_time=iter_time,
            utilization=0.6,
            arrival_time=big_arrival,
        )
    )
    return jobs


def diurnal_trace(
    n_jobs: int = 1_000_000,
    seed: int = 42,
    days: float = 2.0,
    day_seconds: float = 86400.0,
    amplitude: float = 0.8,
    peak_hour: float = 14.0,
    min_iters: int = 1,
    max_iters: int = 3,
    long_frac: float = 0.01,
    names: Optional[List[str]] = None,
) -> List[JobSpec]:
    """Production-shaped diurnal submission trace at fleet scale: exactly
    ``n_jobs`` arrivals over ``days`` days whose rate follows a sinusoid
    peaking at ``peak_hour`` (``amplitude`` = peak-to-mean swing), the
    classic day/night cluster load curve. Jobs are short exploratory runs
    (``min_iters``..``max_iters`` iterations, the 1-3-iteration mass that
    dominates production submission logs) with a ``long_frac`` tail of
    10-30x longer trainings.

    Built for the million-job sweep (``bench_simloop``): arrival times
    come from numpy — sorted uniforms pushed through the inverse of the
    discretized cumulative intensity — so generation is O(n) vectorized
    work, not n expovariate calls. Deterministic in the seed.
    """
    import numpy as np  # local: keeps the stdlib-only import surface lazy

    if n_jobs < 1:
        raise ValueError(f"n_jobs must be >= 1, got {n_jobs}")
    if not (0.0 <= amplitude < 1.0):
        raise ValueError(f"amplitude must be in [0, 1), got {amplitude}")
    rng = np.random.default_rng(seed)
    horizon = days * day_seconds
    # inhomogeneous-Poisson order statistics: conditional on the count,
    # arrivals are iid with density lambda(t)/Lambda(T); invert the
    # cumulative intensity on a fine grid.
    grid = np.linspace(0.0, horizon, max(1024, int(2048 * days)))
    rate = 1.0 + amplitude * np.cos(
        2.0 * math.pi * (grid - peak_hour * 3600.0) / day_seconds
    )
    cum = np.cumsum(rate)
    cum = (cum - cum[0]) / (cum[-1] - cum[0])
    arrivals = np.interp(np.sort(rng.random(n_jobs)), cum, grid)

    pool = sorted(names or PAPER_WORKLOADS)
    which = rng.integers(0, len(pool), n_jobs)
    iters = rng.integers(min_iters, max_iters + 1, n_jobs)
    if long_frac > 0.0:
        tail = rng.random(n_jobs) < long_frac
        iters = np.where(tail, iters * rng.integers(10, 31, n_jobs), iters)

    by_name = []
    for name in pool:
        p, e, t, u = PAPER_WORKLOADS[name]
        by_name.append((name, MemoryProfile(int(p * MB), int(e * MB)), t, u))
    arrivals_l = arrivals.tolist()
    which_l = which.tolist()
    iters_l = iters.tolist()
    jobs: List[JobSpec] = []
    for i in range(n_jobs):
        name, prof, iter_time, util = by_name[which_l[i]]
        jobs.append(
            JobSpec(
                name=f"{name}#{i}",
                profile=prof,
                n_iters=iters_l[i],
                iter_time=iter_time,
                utilization=util,
                arrival_time=arrivals_l[i],
            )
        )
    return jobs


def hyperparam_trace(
    name: str,
    n_jobs: int = 300,
    seed: int = 7,
    base_iters: int = 200,
) -> List[JobSpec]:
    """Paper §5.2: a hyper-parameter sweep is n_jobs copies of one workload
    arriving together; most are killed early (deemed poor) — modeled as a
    wide spread of iteration counts."""
    rng = random.Random(seed)
    jobs = []
    for i in range(n_jobs):
        frac = rng.random()
        if frac < 0.8:  # killed early
            n_iters = max(5, int(base_iters * rng.uniform(0.05, 0.3)))
        else:
            n_iters = int(base_iters * rng.uniform(0.7, 1.3))
        jobs.append(paper_job(name, n_iters=n_iters, arrival_time=0.0))
    return jobs
