#!/usr/bin/env python3
"""Where the backward kernels' time goes, kernel by kernel, on one NVIDIA
GPU: the flash-attention backward (B2) and the RMSNorm backward (B1).

    python3 scripts/flash_bwd_kernel_times.py [--src DIR] [--sweep]

Builds the port's kernels (``src/repro_torch/csrc``, at first use; with
``--src``, the ``repro_torch`` package under DIR instead, e.g. an unpacked
older commit, so two versions can be timed in turns in one run) and
prints one JSON line a case:

* B2 at the training shapes (1, 4096) with gemma-2b's 8/1 heads of 256,
  qwen3-8b's 32/8 heads of 128 and the same heads of 64, in bf16, and in
  fp32 at gemma-2b's and qwen3-8b's heads and at the parity prompt (1,
  512) with qwen3-8b's heads, under the causal mask: the route, the
  launch plan (``ops.bwd_plan``), each kernel's device microseconds a
  call (``torch.profiler`` over ten calls, after three), the whole call's
  time (CUDA events) and, in the same run, SDPA's backward under autograd
  as the yardstick;
* B1 at its three ``chip_smoke.py`` shapes, (4096, 2048) and (131072, 128)
  bf16 and (8192, 4096) fp32: the launch shape, each kernel's device
  microseconds a call, the call's event time, its host cost (enqueue time,
  no synchronise) and ``F.rms_norm``'s backward in the same run.

``--sweep`` also times B1 at every launch shape its kernel takes at those
d. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (b, s, hq, hkv, d, dtype)
FLASH_SHAPES = [
    (1, 4096, 8, 1, 256, torch.bfloat16),
    (1, 4096, 32, 8, 128, torch.bfloat16),
    (1, 4096, 32, 8, 64, torch.bfloat16),
    (1, 512, 32, 8, 128, torch.float32),
    (1, 4096, 8, 1, 256, torch.float32),
    (1, 4096, 32, 8, 128, torch.float32),
]
RMS_SHAPES = [(4096, 2048, torch.bfloat16), (131072, 128, torch.bfloat16),
              (8192, 4096, torch.float32)]
CALLS = 10


def event_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Host-clock milliseconds to enqueue one call, no synchronise inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def device_us(fn) -> dict:
    """Device microseconds a call of each kernel ``fn`` launches."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    us = {}
    for evt in prof.key_averages():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            name = re.sub(r"^(void )?\(anonymous namespace\)::", "", evt.key).split("(")[0]
            us[name] = us.get(name, 0.0) + evt.self_device_time_total / CALLS
    return us


def flash_case(ops, b, s, hq, hkv, d, dtype) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
    g = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
    out, lse = ops._forward(q, k, v, True, None, 0, want_lse=True)
    run = lambda: ops.flash_attention_bwd(g, q, k, v, out, lse)
    us = device_us(run)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    y = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hq != hkv)
    sdpa = lambda: torch.autograd.grad(y, (qt, kt, vt), g.transpose(1, 2), retain_graph=True)
    # the route as this version's wrapper names it (older ones: ``route``)
    route = getattr(ops, "bwd_route", ops.route)(dtype, d)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    got = run()
    want = attention_bwd_ref(g, q, k, v, out, lse)
    rel = {n: ((a.float() - w.float()).norm() / w.float().norm()).item()
           for n, a, w in zip(("dq", "dk", "dv"), got, want)}
    del got, want
    return {
        "kernel": "flash_attention_bwd",
        "shape": {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d},
        "dtype": str(dtype).removeprefix("torch."), "route": route,
        "plan": ops.bwd_plan(b, s, s, hq, hkv, d, True)._asdict() if route != "simt" else None,
        "device_us_by_kernel": us,
        "rel_fro_vs_plain": rel,
        "ms": event_ms(run, CALLS),
        "sdpa_backward_ms": event_ms(sdpa, CALLS),
    }


def rms_case(ops, rows, d, dtype) -> dict:
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    scale = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0).to(dtype)
    g = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    run = lambda: ops.rmsnorm_bwd(g, x, scale)
    xl, sl = x.clone().requires_grad_(), scale.clone().requires_grad_()
    y = F.rms_norm(xl, (d,), sl, 1e-6)
    lib = lambda: torch.autograd.grad(y, (xl, sl), g, retain_graph=True)
    return {
        "kernel": "rmsnorm_bwd", "shape": [rows, d], "dtype": str(dtype).removeprefix("torch."),
        "launch_shape": ops.bwd_launch_shape(d, x.element_size())._asdict(),
        "device_us_by_kernel": device_us(run),
        "ms": event_ms(run, 50),
        "host_ms": host_ms(run, 200),
        "rms_norm_backward_ms": event_ms(lib, 50),
    }


def rms_sweep(ops, rows, d, dtype) -> dict:
    """B1's kernels at launch shapes beside the wrapper's own: every
    (threads a row, ring depth, blocks an SM) the kernel takes at this d,
    each kernel's device microseconds a call summed, and whether dx has
    the wrapper's bits (another threads-a-row sums a row in another
    order), so the choice of ``bwd_launch_shape`` rests on numbers."""
    from repro_torch.kernels import _build

    gen = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    scale = (torch.randn(d, generator=gen, device="cuda") * 0.1 + 1.0).to(dtype)
    g = torch.randn(rows, d, generator=gen, device="cuda").to(dtype)
    want = ops.rmsnorm_bwd(g, x, scale)[0]
    es, vec = x.element_size(), 16 // x.element_size()
    n_vec = d // vec
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    code = _build.DTYPE_CODES[dtype]
    lib = _build.library()
    out = {}
    for tpr in (2 ** i for i in range(9)):
        vpt = -(-n_vec // tpr)
        if tpr > n_vec or vpt not in (1, 2, 4, 8, 16) or vpt * vec > ops.BWD_REGISTER_VALUES:
            continue
        for stages in range(1, ops.BWD_MAX_STAGES + 1):
            shape = ops.BwdShape(vec, tpr, vpt, ops.BWD_BLOCK // tpr, stages)
            if ops.bwd_smem_bytes(shape, d, es) > ops.BWD_MAX_SMEM:
                continue
            for per_sm in (1, 2):
                blocks = max(1, min(-(-rows // shape.rows_per_block), per_sm * sms))
                part = torch.empty(blocks * d, dtype=torch.float32, device="cuda")
                dx, ds = torch.empty_like(x), torch.empty_like(scale)
                call = lambda: lib.rmsnorm_bwd(
                    g.data_ptr(), x.data_ptr(), scale.data_ptr(), dx.data_ptr(), ds.data_ptr(),
                    part.data_ptr(), rows, d, 1e-6, code, code, vec, tpr, vpt, stages, blocks,
                    0, torch.cuda.current_stream().cuda_stream)
                if call() != 0:
                    continue
                torch.cuda.synchronize()
                same = bool(torch.equal(dx, want))
                out[f"tpr{tpr}_vpt{vpt}_stages{stages}_blocks{blocks}"] = (
                    round(sum(device_us(call).values()), 2), same)
    return {"kernel": "rmsnorm_bwd_sweep", "shape": [rows, d],
            "dtype": str(dtype).removeprefix("torch."),
            "wrapper_shape": ops.bwd_launch_shape(d, es)._asdict(), "us_and_same_dx": out}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="directory holding the repro_torch package to time")
    parser.add_argument("--sweep", action="store_true",
                        help="also time B1 at every launch shape it takes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.fused_rmsnorm import ops as rms

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"src": str(args.src.resolve())}), flush=True)
    for shape in FLASH_SHAPES:
        print(json.dumps(flash_case(fa, *shape)), flush=True)
        torch.cuda.empty_cache()
    for shape in RMS_SHAPES:
        print(json.dumps(rms_case(rms, *shape)), flush=True)
        if args.sweep:
            print(json.dumps(rms_sweep(rms, *shape)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
