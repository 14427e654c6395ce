#!/usr/bin/env python3
"""The WKV6 backward (B3) on one NVIDIA GPU, at rwkv6-7b's 64 heads of 64.

    python3 scripts/wkv6_bwd_times.py [--src DIR] [--label NAME]

Builds the port's kernels (``src/repro_torch/csrc``, at first use; with
``--src``, the ``repro_torch`` package under DIR instead, e.g. an unpacked
older commit, so two versions can be timed in turns in one run) and
prints the card's name and power limit, then one JSON line a shape, in
the slow decay regime of ``chip_smoke.py`` with a cotangent on the
output: (4, 16), the serve prompt; (1, 512), the parity prompt; (1,
2048); (1, 4096), a training microbatch. Each line has the call's time
(CUDA events over ``CALLS`` calls, after a warm-up), each kernel's
device microseconds a call (``torch.profiler``), the blocks each kernel
keeps resident an SM (where the library reports it), and at (1, 512) the
largest relative Frobenius gap of any gradient from the plain version.
Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

from flash_bwd_kernel_times import CALLS, device_us, event_ms

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(4, 16), (1, 512), (1, 2048), (1, 4096)]
HEADS, DIM = 64, 64


def occupancy() -> dict | None:
    """Blocks resident an SM of each B3 kernel at 64 x 64, from the
    library's ``wkv6_bwd_occupancy`` (None in a version without it)."""
    from repro_torch.kernels import _build

    lib = _build.library()
    if not hasattr(lib, "wkv6_bwd_occupancy"):
        return None
    fn = lib.wkv6_bwd_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = (ctypes.c_int * 4)()
    _build.check(fn(DIM, DIM, torch.cuda.current_device(), ctypes.addressof(out)),
                 "wkv6_bwd_occupancy")
    return {"bound_kernel": out[0], "chunk_kernel": out[1], "du_kernel": out[2],
            "chunk_threads": out[3]}


def case(ops, b, s) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(s * 17 + b)
    r, k, v = (torch.randn(b, s, HEADS, DIM, generator=gen, device="cuda") for _ in range(3))
    w = torch.sigmoid(torch.randn(b, s, HEADS, DIM, generator=gen, device="cuda")) * 0.1 + 0.88
    u = torch.randn(HEADS, DIM, generator=gen, device="cuda") * 0.1
    do = torch.randn(b, s, HEADS, DIM, generator=gen, device="cuda")
    run = lambda: ops.wkv6_bwd(do, None, r, k, v, w, u)
    res = {"kernel": "wkv6_bwd", "shape": {"b": b, "s": s, "h": HEADS, "d": DIM},
           "ms": event_ms(run, CALLS if s <= 2048 else CALLS // 2),
           "device_us_by_kernel": device_us(run)}
    if s == 512:
        from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref

        got, want = run(), wkv6_bwd_ref(do, None, r, k, v, w, u)
        res["rel_fro_vs_plain"] = max(((a - x).norm() / x.norm()).item()
                                      for a, x in zip(got, want) if x is not None)
    return res


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--src", type=Path, default=ROOT / "src",
                        help="directory holding the repro_torch package to time")
    parser.add_argument("--label", default="", help="a name printed with each line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("wkv6_bwd_times: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.src.resolve()))
    from repro_torch.kernels.rwkv_scan import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    print(json.dumps({"label": args.label, "src": str(args.src.resolve()),
                      "blocks_an_sm": occupancy()}), flush=True)
    for b, s in SHAPES:
        print(json.dumps({"label": args.label, **case(ops, b, s)}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
