#!/usr/bin/env python3
"""Where the WKV6 kernel's time goes, phase by phase, on one NVIDIA GPU.

    python3 scripts/wkv6_phase_cycles.py

Builds ``src/repro_torch/csrc/wkv6.cu`` with ``-DWKV6_PHASE_CYCLES`` (into
``build/repro_torch/phase_cycles/``, apart from the library the port
loads), runs it at the prefill shapes, and prints one JSON line a shape:
each warp's busy cycles a chunk (``clock64``, barrier waits excluded) in
block (0, 0, 0), by phase: the scan, the scores (the last warp: its
copies of the next chunk), the decay pass, the outputs and the state
update; the cycles a chunk along the critical path (the slowest warp
between two barriers); the kernel's time (CUDA events); and the SM clock
that path implies. Profilers
that count instructions (Nsight Compute) need not be present.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

PHASES = ["scan", "scores_or_copies", "decay_pass", "outputs", "state"]
WARPS = 16
SHAPES = [  # (b, s, h, d, chunk, state columns a block)
    (1, 2048, 64, 64, 64, 32),
    (1, 2048, 64, 64, 64, 64),
    (1, 512, 64, 64, 64, 32),
]


def build() -> ctypes.CDLL:
    from repro_torch.kernels import _build

    out = _build.BUILD_ROOT / "phase_cycles"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "libwkv6_phase_cycles.so"
    cmd = [_build.nvcc_path(), *_build.ARCH_FLAGS, *_build.CFLAGS, "-DWKV6_PHASE_CYCLES",
           "-shared", "-o", str(lib), str(_build.CSRC / "wkv6.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed:\n{res.stdout}\n{res.stderr}")
    so = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.wkv6_fwd_tiled.argtypes = [p] * 8 + [i] * 6 + [ll] * 12 + [i, i, p]
    so.wkv6_fwd_tiled.restype = i
    so.wkv6_phase_cycles.argtypes = [p]
    so.wkv6_phase_cycles.restype = i
    return so


def main() -> int:
    if not torch.cuda.is_available():
        print("wkv6_phase_cycles: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    so = build()
    counters = (ctypes.c_ulonglong * (len(PHASES) * WARPS))()
    for b, s, h, d, chunk, tile in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(0)
        r, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(3))
        w = torch.sigmoid(torch.randn(b, s, h, d, generator=gen, device="cuda")) * 0.1 + 0.88
        u = torch.randn(h, d, generator=gen, device="cuda") * 0.1
        o = torch.empty_like(v)
        state = torch.empty(b, h, d, d, device="cuda")
        args = [r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), None,
                o.data_ptr(), state.data_ptr(), b, s, h, d, d, chunk,
                *[x for t in (r, k, v, w) for x in t.stride()[:3]], tile, 0,
                torch.cuda.current_stream().cuda_stream]
        assert so.wkv6_fwd_tiled(*args) == 0  # warm-up
        torch.cuda.synchronize()
        assert so.wkv6_phase_cycles(counters) == 0  # zeroes them
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        assert so.wkv6_fwd_tiled(*args) == 0
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end)
        assert so.wkv6_phase_cycles(counters) == 0
        chunks = -(-s // chunk) - 1  # the first chunk is not counted
        per_warp = {name: [counters[i * WARPS + j] / chunks for j in range(WARPS)]
                    for i, name in enumerate(PHASES)}
        # the slowest warp sets each stretch between two barriers: the scan;
        # the scores and the decay pass (the loader's copies beside them);
        # the outputs and the state update
        scores = per_warp["scores_or_copies"]
        critical = (max(per_warp["scan"])
                    + max(max(scores[:-1]) + max(per_warp["decay_pass"][:-1]), scores[-1])
                    + max(o + st for o, st in zip(per_warp["outputs"], per_warp["state"])))
        print(json.dumps({
            "card": smi, "shape": {"b": b, "s": s, "h": h, "d": d, "chunk": chunk,
                                   "state_columns_a_block": tile},
            "cycles_a_chunk_by_warp": {n: [round(x) for x in xs] for n, xs in per_warp.items()},
            "critical_cycles_a_chunk": round(critical),
            "ms": ms,
            # the SM clock if the critical path were the whole run
            "implied_ghz": critical * (chunks + 1) / (ms * 1e6),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
