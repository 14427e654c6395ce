"""End-to-end training CLI (the JAX package's ``launch/train.py``).

    python -m repro_torch.launch.train --arch gemma-2b --steps 200 \\
        --ckpt-dir ckpt --ckpt-every 20 --inject-failure 77 --mesh 1,1
    python -m repro_torch.launch.train --device cpu --arch qwen3-8b --smoke \\
        --steps 8 --batch 8 --seq-len 16 --ckpt-dir ckpt --ckpt-every 2
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu \\
        --arch qwen3-8b --smoke --mesh 2,2 --batch 8 --seq-len 16

Features exercised here (and by examples/torch/train_lm.py + tests):
  * the sharded train step on a (data, model) mesh (``DTensor`` params and
    AdamW state laid out by the sharding rules, ``train/train_step.py``):
    the data axis splits the batch and the model axis the work (tensor
    parallelism, ``dist/api.py``),
  * async checkpointing + resume (restart supervisor, ``restore_on_mesh``),
  * failure injection (--inject-failure N kills the step loop at N),
  * straggler monitor on per-step wall times,
  * optional int8 error-feedback gradient compression (--compress-grads).

The CLI joins the process group its launcher describes: with torchrun's
variables (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``, ``MASTER_PORT``) it
initialises from them, without them it makes a one-rank group over a
``HashStore`` (no network); NCCL on ``cuda``, gloo on ``cpu``; the group
is destroyed on exit. It runs on the card (``LOCAL_RANK``'s) unless given
``--device cpu``; there is no fallback.

On a mesh whose model axis shards a leaf, ``--compress-grads`` forms its
int8 blocks over each rank's piece of the gradient (JAX's over the whole
leaf); at one rank a leaf the two are the same.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs import ArchConfig, get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import device as pick_device
from repro_torch.dist.api import place, use_sharding
from repro_torch.dist.elastic import restore_on_mesh
from repro_torch.dist.fault import FailureInjector, RestartSupervisor, StragglerMonitor
from repro_torch.dist.sharding import batch_shardings, make_context, param_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelOptions, build_model
from repro_torch.models.model import Model
from repro_torch.train.grad_compress import ErrorFeedbackCompressor
from repro_torch.train.optimizer import AdamW, AdamWConfig
from repro_torch.train.train_step import TrainRunConfig, local_pieces, make_train_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="1,1", help="data,model mesh shape")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure", type=int, action="append", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, resolve the config and train (``run``)."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    return run(cfg, args)


@contextlib.contextmanager
def process_group(dev: torch.device):
    """The launcher's group (torchrun's variables), else one rank over a
    ``HashStore``; destroyed on exit."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def compress_in_place(compressor, grads: dict, resid: dict) -> dict:
    """``compressor.apply`` leaf by leaf, each gradient and residual
    replaced in its dict as it goes, so that one leaf's copies are live at
    a time; the same numbers as one ``apply`` over the trees."""
    for k, g in grads.items():
        if isinstance(g, dict):
            compress_in_place(compressor, g, resid[k])
        else:
            grads[k], resid[k] = compressor.apply(g, resid[k])
    return grads


def make_step(model: Model, opt: AdamW, microbatches: int, state: dict, compressor=None):
    """The loop's step on ``state`` (its ``"params"`` and ``"opt"``, and
    with a compressor its ``"resid"``): ``step(batch) -> metrics``.
    Without a compressor it is ``make_train_step`` at ``microbatches``;
    with one, JAX's ``--compress-grads`` path: the gradient of the whole
    batch, ``compressor.apply``, then AdamW."""
    if compressor is None:
        run_cfg = TrainRunConfig(num_microbatches=microbatches)
    else:
        run_cfg = TrainRunConfig(
            grad_transform=lambda g: compress_in_place(compressor, g, state["resid"]))
    step = make_train_step(model, opt, run_cfg)

    def cli_step(batch):
        state["params"], state["opt"], metrics = step(state["params"], state["opt"], batch)
        return metrics

    return cli_step


def abstract_state(model: Model, opt: AdamW) -> dict:
    """The fresh state's params and AdamW state as ``meta`` tensors (shapes
    and dtypes, no bytes): ``model.init`` traced under ``FakeTensorMode``,
    as JAX's ``eval_shape``."""
    with FakeTensorMode():
        params = model.init(torch.Generator())
        tree = {"params": params, "opt": opt.init(params)}
    return pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"), tree)


def run(cfg: ArchConfig, args: argparse.Namespace) -> dict:
    """Train ``cfg`` as the parsed ``args`` say. Returns the loop's
    record: each step's loss and seconds, the steps resumed from, the
    restarts and the stragglers flagged."""
    dev = pick_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    with process_group(dev):
        return _train(cfg, args, dev)


def _train(cfg: ArchConfig, args: argparse.Namespace, dev: torch.device) -> dict:
    mesh = make_mesh(tuple(int(x) for x in args.mesh.split(",")), ("data", "model"), dev.type)
    ctx = make_context(mesh, cfg)
    # the JAX CLI's options; the port's defaults otherwise (the kernels,
    # bf16 compute, remat)
    model = build_model(cfg, ModelOptions(
        loss_chunk=min(512, args.seq_len), moe_group=min(4096, args.batch * args.seq_len),
        wkv_chunk=min(64, args.seq_len), ssm_chunk=min(128, args.seq_len)))
    opt = AdamW(AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                            total_steps=args.steps))
    pipe = SyntheticLM(cfg.vocab_size, args.seq_len, args.batch, seed=0)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir else None
    injector = FailureInjector(args.inject_failure or [])
    monitor = StragglerMonitor()
    compressor = ErrorFeedbackCompressor() if args.compress_grads else None
    b_sh = batch_shardings(cfg, ShapeConfig("cli", "train", args.seq_len, args.batch), mesh)
    on_mesh = lambda tree: place(tree, param_shardings(tree, cfg, mesh))
    state: dict = {}
    step = make_step(model, opt, args.microbatches, state, compressor)
    record: dict = {"losses": {}, "step_s": {}, "resumed": []}

    def fresh_state():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        state["opt"] = on_mesh(opt.init(params))
        state["params"] = on_mesh(params)
        state["resid"] = compressor.init(local_pieces(state["params"])) if compressor else None

    def resume_step() -> int:
        if mgr is not None:
            mgr.wait()  # drain in-flight async saves before picking latest
        if mgr is None or mgr.latest_step() is None:
            fresh_state()
            return 0
        if "params" in state:
            template = {"params": state["params"], "opt": state["opt"]}
        else:  # fresh process resuming an existing run: a meta template
            template = abstract_state(model, opt)
        step_no, tree, _ = restore_on_mesh(mgr, template, cfg, mesh)
        state["params"], state["opt"] = tree["params"], tree["opt"]
        if compressor is not None and state.get("resid") is None:
            state["resid"] = compressor.init(local_pieces(state["params"]))
        print(f"[train] resumed from checkpoint step {step_no}")
        record["resumed"].append(step_no)
        return step_no

    def body(start: int) -> int:
        with use_sharding(ctx):
            for i in range(start, args.steps):
                injector.maybe_fail(i)
                t0 = time.perf_counter()
                batch = place({k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}, b_sh)
                metrics = step(batch)
                loss = float(metrics["loss"])  # waits for the step
                dur = time.perf_counter() - t0
                record["losses"][i], record["step_s"][i] = loss, dur
                rep = monitor.observe(i, dur)
                if rep is not None:
                    print(f"[straggler] step {i}: {dur*1e3:.0f}ms ({rep.sigma:.1f} sigma)")
                if i % args.log_every == 0:
                    print(f"step {i:5d} loss {loss:.4f} "
                          f"gnorm {float(metrics['grad_norm']):.3f} {dur*1e3:.0f}ms")
                if mgr is not None and (i + 1) % args.ckpt_every == 0:
                    mgr.save(i + 1, {"params": state["params"], "opt": state["opt"]})
        if mgr is not None:
            mgr.save(args.steps, {"params": state["params"], "opt": state["opt"]})
            mgr.wait()
        return args.steps

    sup = RestartSupervisor(max_restarts=3)
    sup.run(body, resume_step)
    if sup.restarts:
        print(f"[train] completed after {sup.restarts} restart(s)")
    print(f"[train] done: {args.steps} steps; stragglers flagged: {len(monitor.flagged)}")
    record.update(restarts=sup.restarts, flagged=len(monitor.flagged))
    return record


if __name__ == "__main__":
    main()
