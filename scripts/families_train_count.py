#!/usr/bin/env python3
"""The dry run's count of ``chip_smoke.py``'s ``families_train`` phase, on
the CPU (no card): each arch's session step (``FAMILIES_TRAIN``: full
width, TRAIN_4K's sequence, TRAIN_BATCH rows in the runtime table's
microbatches, kernel mode) counted on one rank under fake tensors, the
kernels by their ``cost`` (``launch.dryrun.count``), and its fp32 parity
passes (fp32 params and compute, one sequence at
``FAMILIES_PARITY_DEPTH`` layers, through the kernels and on the plain
path). It prints one JSON line a cell: the counted peak of live bytes
(GiB; a parity pass's also with a second gradient tree beside it, as the
phase holds the two runs' gradients), the params, and each kernel's
counted launches, which must equal ``chip_smoke.launches_per_microbatch``
times the microbatches (exit 1 otherwise).

    PYTHONPATH=src python3 scripts/families_train_count.py [--arch NAME] [--no-parity]

hymba-1.5b's plain SSM scan makes its cells the slow ones (its parity
cells ~15 s each; its session ~200 s at 32 layers).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import replace
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]  # the port, and chip_smoke's tables

import torch  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.train import train_step  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402

GIB = 2**30


def counted(step, args, microbatches: int, mode: FakeTensorMode) -> tuple:
    """``dryrun.count`` of ``step`` on fakes of ``args`` (real CPU tensors
    or a tree of params made inside the mode): the counter and seconds."""
    t0 = time.perf_counter()
    with mode:
        counter, _, _ = dryrun.count(step, args(), microbatches)
    return counter, time.perf_counter() - t0


def launches(counter) -> dict:
    return {n: counter.kernels.get(n, {}).get("launches", 0) for n in cs.kernel_counters()}


def session_cell(arch: str, depth) -> dict:
    cfg, shape, model, run, ocfg = cs.train_model(n_layers=depth, arch=arch)
    opt = AdamW(ocfg)
    step = train_step.make_train_step(model, opt, run)
    batch = cs.family_batch(cfg, shape, 0, torch.device("cpu"))
    mode = FakeTensorMode()

    def args():
        p = dryrun.abstract_params(model)
        return p, opt.init(p), {k: mode.from_tensor(v) for k, v in batch.items()}

    counter, secs = counted(step, args, run.num_microbatches, mode)
    want = {k: run.num_microbatches * v for k, v in cs.launches_per_microbatch(cfg).items()}
    return {"cell": "session_step", "arch": arch, "n_layers": cfg.n_layers,
            "params": cfg.param_count(), "microbatches": run.num_microbatches,
            "param_dtype": model.opts.param_dtype, "state_dtype": ocfg.state_dtype,
            "peak_gib": counter.peak / GIB, "launches": launches(counter),
            "launches_implied": want, "count_s": secs}


def parity_cells(arch: str) -> list:
    out = []
    depth, seq = cs.FAMILIES_PARITY_DEPTH, cs.FAMILIES_PARITY_SEQ.get(arch, 4096)
    for kernel_mode in ("kernel", "reference"):
        cfg, shape, model, _, _ = cs.train_model(kernel_mode, "float32", depth, arch,
                                                 **cs.PARITY_OPTS)
        batch = cs.family_batch(cfg, replace(shape, seq_len=seq, global_batch=1), 0,
                                torch.device("cpu"))
        mode = FakeTensorMode()
        grads_bytes = []

        def args():
            return (dryrun.abstract_params(model),
                    {k: mode.from_tensor(v) for k, v in batch.items()})

        def step(params, b):
            loss, g = train_step.value_and_grad(model, params, b)
            grads_bytes.append(sum(t.numel() * t.element_size() for t in pytree.tree_leaves(g)))
            return loss, g

        counter, secs = counted(step, args, 1, mode)
        want = cs.launches_per_microbatch(cfg) if kernel_mode == "kernel" else dict.fromkeys(
            cs.kernel_counters(), 0)
        out.append({"cell": f"parity_fp32_{kernel_mode}", "arch": arch, "n_layers": depth,
                    "seq": seq, "params": cfg.param_count(), "peak_gib": counter.peak / GIB,
                    "peak_with_other_grads_gib": (counter.peak + grads_bytes[0]) / GIB,
                    "launches": launches(counter), "launches_implied": want, "count_s": secs})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", help="the arch(s) to count; all by default")
    ap.add_argument("--no-parity", action="store_true")
    args = ap.parse_args(argv)
    archs = args.arch or [a for a, _ in cs.FAMILIES_TRAIN]
    depths = dict(cs.FAMILIES_TRAIN)
    bad = 0
    for arch in archs:
        cells = [session_cell(arch, depths[arch])]
        if not args.no_parity:
            cells += parity_cells(arch)
        for c in cells:
            print(json.dumps(c), flush=True)
            bad += c["launches"] != c["launches_implied"]
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
