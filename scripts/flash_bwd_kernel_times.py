#!/usr/bin/env python3
"""Where the flash-attention backward's time goes, kernel by kernel, on one
NVIDIA GPU.

    python3 scripts/flash_bwd_kernel_times.py

Builds the port's kernels (``src/repro_torch/csrc``, at first use) and, at
the training shapes (1, 4096) with gemma-2b's 8/1 heads of 256, qwen3-8b's
32/8 heads of 128 and the same heads of 64, in bf16 under the causal mask,
prints one JSON line a shape: the launch plan (``ops.bwd_plan``), each
kernel's device microseconds a call (``torch.profiler`` over ten calls,
after three), the whole call's time (CUDA events) and, in the same run,
SDPA's backward under autograd as the yardstick. Exits non-zero without a
CUDA device.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = [(1, 4096, 8, 1, 256), (1, 4096, 32, 8, 128), (1, 4096, 32, 8, 64)]  # (b, s, hq, hkv, d)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    for b, s, hq, hkv, d in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").bfloat16()
        g = torch.randn(b, s, hq, d, generator=gen, device="cuda").bfloat16()
        out, lse = ops._forward(q, k, v, True, None, 0, want_lse=True)
        run = lambda: ops.flash_attention_bwd(g, q, k, v, out, lse)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                run()
            torch.cuda.synchronize()
        us = {}
        for evt in prof.key_averages():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                name = re.sub(r"^(void )?\(anonymous namespace\)::", "", evt.key).split("(")[0]
                us[name] = us.get(name, 0.0) + evt.self_device_time_total / CALLS
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        y = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=hq != hkv)
        sdpa = lambda: torch.autograd.grad(y, (qt, kt, vt), g.transpose(1, 2), retain_graph=True)
        print(json.dumps({
            "shape": {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d},
            "plan": ops.bwd_plan(b, s, s, hq, hkv, d, True)._asdict(),
            "device_us_by_kernel": us,
            "ms": event_ms(run, CALLS),
            "sdpa_backward_ms": event_ms(sdpa, CALLS),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
