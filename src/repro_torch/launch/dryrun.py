"""Dry run: every (arch x shape x mesh) cell's step counted on one rank of
the production mesh, with no device and nothing compiled (the JAX
package's ``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all                  # every runnable cell
    python -m repro_torch.launch.dryrun --all --both-meshes    # 16x16 and 2x16x16

For each cell it builds the port's real train, prefill or decode step on a
fake process group of 256 ranks (16x16) or 512 (2x16x16), the params,
AdamW state, batch and cache fake tensors laid out by the sharding rules,
runs the step once as rank 0 under ``launch/op_count.py``'s counter and
writes one JSON a cell under ``--out``: the rank's FLOPs, HBM bytes,
collectives and peak live bytes, and the roofline terms at the H100's
figures (``launch/roofline.py``). The fake tensors are on ``cuda`` where
torch is built with CUDA; a CPU-only build cannot index a fake ``cuda``
tensor, so there they are on the CPU, and the kernel wrappers take their
fake branch on either. Under ``--kernel-mode kernel`` each kernel is
counted by its ``cost``; under ``reference`` (the default, as JAX's) its
plain version runs and is counted op by op.

A train cell runs its first microbatch's pass (forward, the remat
recompute, which the count holds as JAX's HLO holds its own, and
backward) and counts it ``num_microbatches`` times, as ``analyze_hlo``
multiplies a loop body by its trip count; the other microbatches take
empty gradients of the same shapes; the accumulation and the AdamW step
run as they are. A rank splits its own rows into microbatches, so the
runtime table's count is capped to divide them: the 16-microbatch cells
on 2x16x16 (8 rows a rank) run 8, the same rows a rank in all.

The report has JAX's keys, except: ``fits_80GB`` for ``fits_16GB``;
``kernel_mode`` and ``count_s`` for ``compile_s``; no
``cpu_upcast_bytes``, ``peak_bytes_projected_tpu`` or
``fits_16GB_cpu_measured`` (they correct XLA's CPU artifacts, f32 twins of
bf16 buffers and copies at loop boundaries, which eager PyTorch does not
make), no ``xla_cost_analysis`` or ``unknown_loops`` (XLA's analysis and
loops) and no ``generated_code_bytes`` (no compiled code). ``kernels``
(launches, operations and bytes by kernel) and ``flops_by_op`` are the
port's own.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time
import traceback
from dataclasses import replace
from pathlib import Path
from unittest import mock

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils import _pytree as pytree

from repro_torch.configs import all_cells, get_config, get_shape
from repro_torch.configs.base import batch_spec
from repro_torch.dist.api import place, use_sharding
from repro_torch.dist.sharding import (
    batch_shardings,
    cache_shardings,
    make_context,
    param_shardings,
)
from repro_torch.launch import roofline
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_count import OpCounter, times, track
from repro_torch.models import build_model
from repro_torch.train import train_step
from repro_torch.train.optimizer import AdamW
from repro_torch.train.runtime import adamw_config_for, model_options_for, train_run_config_for
from repro_torch.train.serve_step import make_decode_step, make_prefill_step

DEVICE = "cuda" if torch.backends.cuda.is_built() else "cpu"
DEVICE_BYTES = 80 * 2**30  # an H100 80GB
ROW = ("OK %-22s %-12s %-8s peak=%6.2fGiB fits=%s compute=%9.3fms memory=%9.3fms coll=%9.3fms "
       "dom=%-10s useful=%5.1f%% (%.0fs)")


def abstract_params(model, device: str = DEVICE):
    """``model.init``'s tree as fake tensors on ``device``, nothing drawn
    (``init`` runs on fake tensors); call inside a fake mode."""
    return pytree.tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype, device=device),
                           model.init(torch.Generator()))


def fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0 (a
    group of another size or backend is replaced); meshes over it are made
    outside any fake mode."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized() and (dist.get_backend() != "fake" or dist.get_world_size() != world):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _first_pass(counter, n, real, first, model, params, batch):
    """A train step's microbatch pass: the first counted ``n`` times, the
    later ones empty gradients of its shapes, uncounted."""
    if first:
        return pytree.tree_unflatten([torch.empty(s, dtype=d, device=v) for s, d, v in first[0]],
                                     first[1])
    with times(counter, n):
        out = real(model, params, batch)
    leaves, spec = pytree.tree_flatten(out)
    first[:] = [(t.shape, t.dtype, t.device) for t in leaves], spec
    return out


def count(step, args, microbatches: int = 1):
    """Run ``step(*args)`` once under a fresh counter, its arguments counted
    live first; returns ``(counter, output, memory)``, ``memory`` JAX's
    ``memory_analysis`` fields from the live bytes."""
    counter = OpCounter()
    arg_bytes = track(counter, args)
    once = functools.partial(_first_pass, counter, microbatches, train_step.value_and_grad, [])
    with counter, mock.patch.object(train_step, "value_and_grad", once):
        out = step(*args)
    outs = track(counter, out)
    alias = sum(b for k, b in outs.items() if k in arg_bytes)
    arg, output = sum(arg_bytes.values()), sum(outs.values())
    return counter, out, {"argument_bytes": arg, "output_bytes": output,
                          "temp_bytes": counter.peak - arg - output + alias, "alias_bytes": alias}


def build_cell(cfg, shape, mesh, kernel_mode: str = "reference",
               local_grad_accum: bool = False, microbatch_override: int = 0,
               kv_quantized=None, zero3: bool = False):
    """``(step, arguments, microbatches)`` of the cell, the arguments
    placed on ``mesh``; call inside a fake mode."""
    if not cfg.supports(shape):
        raise ValueError(f"{cfg.name} skips {shape.name} (full attention @500k)")
    opts = model_options_for(cfg, shape, kernel_mode=kernel_mode)
    if kv_quantized is not None:
        opts.kv_quantized = kv_quantized
    model, opt, kind = build_model(cfg, opts), AdamW(adamw_config_for(cfg)), shape.kind
    args = [abstract_params(model), {k: torch.zeros(s, dtype=getattr(torch, dt), device=DEVICE)
                                     for k, (s, dt) in batch_spec(cfg, shape).items()}]
    if kind == "train":
        args.insert(1, opt.init(args[0]))
    if kind == "decode":
        args.append(model.init_cache(shape.global_batch, shape.seq_len, device=DEVICE))
    lays = [param_shardings(args[0], cfg, mesh, serve=kind != "train", zero3=zero3)]
    if kind == "train":
        lays.append(param_shardings(args[1], cfg, mesh, zero3=zero3))
    lays.append(batch_shardings(cfg, shape, mesh))
    if kind == "decode":
        lays.append(cache_shardings(args[2], cfg, shape, mesh))
    args = [place(a, lay) for a, lay in zip(args, lays)]
    if kind == "train":
        run = train_run_config_for(cfg, shape)
        # a rank splits its own rows: the table's microbatches capped to
        # divide them (16 on 2x16x16, 8 rows a rank, run as 8)
        rows = args[2]["labels"].to_local().shape[0]
        run = replace(run, num_microbatches=microbatch_override
                      or math.gcd(run.num_microbatches, rows))
        if local_grad_accum:  # the accumulator as the params, data axes replicated (_drop_data)
            run = replace(run, grad_accum_shardings=pytree.tree_map(
                lambda p: (mesh, train_step._model_placements(p)), args[0]))
        return train_step.make_train_step(model, opt, run), args, run.num_microbatches
    if kind == "decode":  # one new token a sequence against a cache of seq_len tokens
        return make_decode_step(model), args + [shape.seq_len - 1], 1
    return make_prefill_step(model, max_len=shape.seq_len), args, 1


def analyze(counter: OpCounter, memory: dict, cfg, shape, n_dev: int) -> dict:
    flops, coll = counter.flops, sum(counter.collective_bytes.values())
    model_flops = (6.0 if shape.kind == "train" else 2.0) * cfg.active_param_count() \
        * shape.tokens_per_step / n_dev
    return {
        "arch": cfg.name, "shape": shape.name, "n_devices": n_dev, "memory": memory,
        "peak_bytes_per_device": counter.peak, "fits_80GB": counter.peak <= DEVICE_BYTES,
        "flops_per_device": flops, "hbm_bytes_per_device": counter.hbm_bytes,
        "collectives": {"counts": counter.collective_counts,
                        "bytes_by_op": counter.collective_bytes, "total_bytes": coll,
                        "total_count": sum(counter.collective_counts.values())},
        "roofline": roofline.roofline_terms(flops, counter.hbm_bytes, coll),
        "model_flops_per_device": model_flops,
        "useful_flops_ratio": model_flops / flops if flops else 0.0,
        "kernels": counter.kernels, "flops_by_op": counter.flops_by_op,
    }


def _path(out_dir, arch_name, shape_name, mesh_tag, tag) -> Path:
    return Path(out_dir) / f"{arch_name}__{shape_name}__{mesh_tag}{'__' + tag if tag else ''}.json"


def run_cell(arch_name, shape_name, multi_pod, out_dir, kernel_mode="reference", tag="",
             **cell_kwargs) -> dict:
    t0, mesh_tag = time.time(), "2x16x16" if multi_pod else "16x16"
    cfg, shape = get_config(arch_name), get_shape(shape_name)
    fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=DEVICE)
    with FakeTensorMode():
        step, args, n_mb = build_cell(cfg, shape, mesh, kernel_mode, **cell_kwargs)
        with use_sharding(make_context(mesh, cfg, zero3=cell_kwargs.get("zero3", False))):
            counter, _, memory = count(step, args, n_mb)
    report = analyze(counter, memory, cfg, shape, mesh.size())
    report.update(mesh=mesh_tag, microbatches=n_mb, kernel_mode=kernel_mode, tag=tag,
                  count_s=time.time() - t0)
    path = _path(out_dir, arch_name, shape_name, mesh_tag, tag)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2))
    r = report["roofline"]
    print(ROW % (arch_name, shape_name, mesh_tag, counter.peak / 2**30, report["fits_80GB"],
                 r["compute_s"] * 1e3, r["memory_s"] * 1e3, r["collective_s"] * 1e3,
                 r["dominant"], report["useful_flops_ratio"] * 100, report["count_s"]), flush=True)
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    for flag, default in (("--arch", None), ("--shape", None), ("--tag", ""),
                          ("--out", "experiments/dryrun"), ("--kernel-mode", "reference")):
        ap.add_argument(flag, default=default)
    ap.add_argument("--microbatches", type=int, default=0)
    for flag in ("--all", "--multi-pod", "--both-meshes", "--skip-existing", "--local-grad-accum",
                 "--zero3", "--kv-bf16"):
        ap.add_argument(flag, action="store_true")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("--arch and --shape required unless --all")
    cells = [(a.name, s.name) for a, s in all_cells()] if args.all else [(args.arch, args.shape)]
    failures = []
    for mp in [False, True] if args.both_meshes else [args.multi_pod]:
        for cell in cells:
            mesh_tag = "2x16x16" if mp else "16x16"
            if args.skip_existing and _path(args.out, *cell, mesh_tag, args.tag).exists():
                print("SKIP", *cell, mesh_tag, "(exists)")
                continue
            try:
                run_cell(*cell, mp, args.out, args.kernel_mode, args.tag,
                         local_grad_accum=args.local_grad_accum,
                         microbatch_override=args.microbatches,
                         kv_quantized=False if args.kv_bf16 else None, zero3=args.zero3)
            except Exception as e:  # noqa: BLE001 - report all cell failures
                failures.append((*cell, mesh_tag, repr(e)))
                print("FAIL", *cell, mesh_tag, e)
                traceback.print_exc()
    if dist.is_initialized():
        dist.destroy_process_group()
    for f in failures:
        print("  ", *f)
    if failures:
        sys.exit(f"{len(failures)} FAILURES")
    print("\nall cells OK")


if __name__ == "__main__":
    main()
