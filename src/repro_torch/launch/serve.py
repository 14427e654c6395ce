"""Open-loop Salus serving driver on one device (paper §5.3, Fig. 9/10):
hold several inference services resident on one device, feed each a
Poisson request stream, optionally co-locate one best-effort background
training job that the PRIORITY policy preempts at iteration boundaries,
and report per-service p50/p95/p99 request latency and the trainer's
iterations and preemptions. Each request is one prefill of a ``(4, 16)``
prompt followed by an argmax over the last position; each training
iteration is one gradient step on ``(2, 16)`` tokens. Requests and
batches hold tokens only, as the JAX driver's do, so musicgen-medium
(frame embeddings) and qwen2-vl-72b (M-RoPE positions) are not served
here; they run through ``Model.prefill`` and ``Model.decode``.

    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --archs gemma-2b,qwen3-8b,rwkv6-7b --rps 2 --duration 10 \\
        --train-background gemma-2b

``--no-smoke`` runs the full-size configs (smoke-scale is the default);
``--device cpu`` runs on the CPU (the default is the card, and there is
no fallback).
"""
from __future__ import annotations

import argparse
import random
import time
import zlib
from typing import Mapping

import torch
from torch.utils import _pytree as pytree

from repro_torch.configs import ArchConfig, get_config
from repro_torch.core import GB, SalusExecutor, VirtualDevice, get_policy
from repro_torch.core.tracegen import poisson_arrivals
from repro_torch.device import device as pick_device
from repro_torch.models import ModelOptions, build_model
from repro_torch.train.train_step import stack_grads, value_and_grad

PROMPT_SHAPE = (4, 16)
TRAIN_SHAPE = (2, 16)
# the options of the JAX package's launch/serve.py: a (4, 16) prompt is
# two WKV chunks for rwkv and two SSM chunks for hymba, MoE routes groups
# of 16 tokens, and the trainer's loss head runs over chunks of 8
SERVE_OPTS = ModelOptions(wkv_chunk=8, moe_group=16, ssm_chunk=8)
TRAIN_OPTS = ModelOptions(wkv_chunk=8, loss_chunk=8, moe_group=16, ssm_chunk=8)
TRAIN_LR = 1e-4


def stable_seed(name: str) -> int:
    """Deterministic per-service seed: crc32 is a stable digest, where
    ``hash(str)`` is salted per process."""
    return zlib.crc32(name.encode("utf-8")) % 2**31


def make_service(
    name: str, smoke: bool, max_len: int = 64, device="cuda",
    opts: ModelOptions | None = None, cfg: ArchConfig | None = None,
):
    """One resident inference service: (handle, params, data_fn). Params
    are drawn from a generator seeded by ``stable_seed(name)``; request
    ``i`` comes from a generator seeded by ``i``. ``opts`` defaults to
    ``SERVE_OPTS``; ``cfg`` to the registry's config of ``name`` (reduced
    by ``smoke``)."""
    dev = torch.device(device)
    if cfg is None:
        cfg = get_config(name)
        if smoke:
            cfg = cfg.smoke()
    model = build_model(cfg, opts or SERVE_OPTS)
    params = model.init(torch.Generator(device=dev).manual_seed(stable_seed(name)))

    def handle(state, request):
        logits, _ = model.prefill(state, request, max_len=max_len)
        return state, {"next_token": torch.argmax(logits, dim=-1)}

    def data_fn(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        tokens = torch.randint(
            0, cfg.vocab_size, PROMPT_SHAPE, generator=gen, device=dev
        )
        return {"tokens": tokens}

    return handle, params, data_fn


def make_trainer(name: str, smoke: bool, device="cuda", opts: ModelOptions | None = None):
    """The best-effort background training job of the Fig. 9/10 regime:
    (step, params, data_fn). A step is the JAX launcher's: the loss's
    gradient and plain SGD, ``p - 1e-4 g``, returning new params (the step
    is functional, so the session's state is whatever the executor last
    handed it, and profiling it takes no hidden step). Params are drawn
    from a generator seeded by ``stable_seed(name) ^ 0x5A105``; batch ``i``
    is ``(2, 16)`` tokens from a generator seeded by ``i``, with the labels
    the tokens rolled by one. ``opts`` defaults to ``TRAIN_OPTS``."""
    dev = torch.device(device)
    cfg = get_config(name)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, opts or TRAIN_OPTS)
    params = model.init(
        torch.Generator(device=dev).manual_seed(stable_seed(name) ^ 0x5A105)
    )

    def step(params, batch):
        loss, grads = value_and_grad(model, params, batch)
        with torch.no_grad():
            new = pytree.tree_map(lambda p, g: p - TRAIN_LR * g, params, stack_grads(grads))
        return new, {"loss": loss}

    def data_fn(i):
        gen = torch.Generator(device=dev).manual_seed(i)
        tokens = torch.randint(0, cfg.vocab_size, TRAIN_SHAPE, generator=gen, device=dev)
        return {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=-1)}

    return step, params, data_fn


def poisson_requests(rps: float, duration: float, rng: random.Random):
    """Per-service request stream (shared generator, ms-precision times)."""
    return tuple(round(t, 6) for t in poisson_arrivals(rps, duration, rng))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--archs", default="gemma-2b,qwen3-8b,rwkv6-7b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--rps", type=float, default=2.0, help="requests/s per service")
    ap.add_argument("--duration", type=float, default=10.0, help="open-loop window (s)")
    ap.add_argument(
        "--requests", type=int, default=None,
        help="cap on requests per service (default: whatever the stream yields)",
    )
    ap.add_argument(
        "--train-background", default=None, metavar="ARCH",
        help="co-locate one best-effort training job of this arch",
    )
    ap.add_argument("--train-iters", type=int, default=200)
    ap.add_argument("--capacity-gb", type=float, default=8.0)
    ap.add_argument("--policy", default="priority")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None):
    """Parse ``argv``, serve, print the report; returns the report."""
    return serve(build_parser().parse_args(argv))[0]


def serve(args: argparse.Namespace, configs: Mapping[str, ArchConfig] | None = None):
    """Build the services on one executor and run them; returns
    ``(report, executor)`` (the executor holds the sessions). ``configs``
    maps a service's name to the config it serves in place of the
    registry's: ``chip_smoke.py``'s moe phase serves mixtral-8x22b at a
    depth cut to fit one card through it, since the CLI (like the JAX
    package's) has no depth flag."""
    dev = pick_device(args.device)
    ex = SalusExecutor(
        capacity=int(args.capacity_gb * GB), policy=get_policy(args.policy), device=dev
    )
    vdev = VirtualDevice(ex)
    names = args.archs.split(",")
    rng = random.Random(args.seed)
    for name in names:
        handle, params, data_fn = make_service(
            name, args.smoke, device=dev, cfg=(configs or {}).get(name))
        reqs = poisson_requests(args.rps, args.duration, rng)
        if args.requests is not None:
            reqs = reqs[: args.requests]
        vdev.create_session(
            name, handle, params, data_fn, n_iters=len(reqs),
            kind="inference", utilization=0.3, request_times=reqs,
        )
        del params  # the session holds the only reference (paging frees it)
    if args.train_background:
        step, params, data_fn = make_trainer(args.train_background, args.smoke, device=dev)
        vdev.create_session(
            f"train:{args.train_background}", step, params, data_fn,
            n_iters=args.train_iters, kind="train", utilization=0.9,
        )
        del params
    print(f"[serve] packed {len(names)} services into 1 device ({dev}, "
          f"{ex.registry.stats()['n_lanes']} lanes, "
          f"{ex.registry.stats()['free']/2**30:.1f} GiB free"
          + (f", + background training {args.train_background}"
             if args.train_background else "") + ")")
    t0 = time.perf_counter()
    report = vdev.run(max_wall=args.duration + 5.0)
    dt = time.perf_counter() - t0
    total = sum(
        s.iterations_done for jid, s in report.stats.items()
        if ex.sessions[jid].job.kind == "inference"
    )
    print(f"[serve] {total} requests in {dt:.2f}s "
          f"({total/dt:.1f} req/s across {len(names)} resident services)")
    for jid, s in report.stats.items():
        job = ex.sessions[jid].job
        if job.kind == "inference":
            ms = lambda v: f"{v*1e3:.1f}" if v is not None else "n/a"
            print(f"  {job.name}: {s.iterations_done} reqs, latency ms "
                  f"p50={ms(s.p50_latency)} p95={ms(s.p95_latency)} "
                  f"p99={ms(s.p99_latency)}")
        else:
            print(f"  {job.name}: {s.iterations_done} training iterations "
                  f"({s.preemptions} boundary preemptions)")
    for jid, err in report.failures.items():
        print(f"  FAILED {ex.sessions[jid].job.name}: {err}")
    return report, ex


if __name__ == "__main__":
    main()
