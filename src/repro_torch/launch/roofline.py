"""Roofline terms on the H100 (the JAX package's
``launch/hlo_analysis.py::roofline_terms``, with the H100's figures in
place of v5e's; ``PERF.md``'s Bound column divides each kernel's ``cost``
by the same figures), and ``report``: the JAX package's
``benchmarks/roofline_report.py`` row for each cell report the dry run
(``launch/dryrun.py``) writes.

    python -m repro_torch.launch.roofline [DIRECTORY]
"""
from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Dict

import torch

# H100 SXM published peaks (dense): HBM3, bf16 on the tensor cores, and
# fp32 outside them (the norms' and WKV6's elementwise arithmetic)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# fp32-accurate products on the tensor cores: three TF32 products each
# (3xTF32), so the TF32 line over three: fp32 attention's least time
PEAK_FLOPS_FP32_ATTENTION = 494.7e12 / 3
# one NVLink 4 link, one direction: the H100 SXM datasheet's 900 GB/s of
# NVLink a GPU counts both directions of its 18 links. One link term, as
# JAX's ICI term; no topology model
NVLINK_BYTES_PER_S = 25e9


ROW = ("roofline_%s_%s_%s%s,%.3f,compute_ms=%.2f;memory_ms=%.2f;collective_ms=%.2f;dominant=%s;"
       "roofline_frac=%.3f;useful_flops=%.2f;peak_gib=%.2f;fits=%s")


def roofline_terms(flops: float, hbm_bytes: float, collective_bytes: float) -> Dict:
    """A rank's step bound by its FLOPs at the bf16 peak, its HBM bytes and
    its collectives' operand bytes over one link."""
    terms = {"compute_s": flops / PEAK_FLOPS[torch.bfloat16],
             "memory_s": hbm_bytes / HBM_BYTES_PER_S,
             "collective_s": collective_bytes / NVLINK_BYTES_PER_S}
    bound = max(terms.values())
    return {**terms, "dominant": max(terms, key=terms.get)[:-2], "step_lower_bound_s": bound,
            "roofline_fraction": terms["compute_s"] / bound if bound > 0 else 0.0}


def report(directory) -> None:
    """One CSV row (name, bound µs, terms) a cell report in ``directory``."""
    paths = sorted(Path(directory).glob("*.json"))
    if not paths:
        print(f"roofline_no_data,0.000,run launch/dryrun.py first ({directory})")
    for path in paths:
        r = json.loads(path.read_text())
        t = r["roofline"]
        print(ROW % (r["arch"], r["shape"], r["mesh"], "_" + r["tag"] if r.get("tag") else "",
                     t["step_lower_bound_s"] * 1e6, t["compute_s"] * 1e3, t["memory_s"] * 1e3,
                     t["collective_s"] * 1e3, t["dominant"], t["roofline_fraction"],
                     r["useful_flops_ratio"], r["peak_bytes_per_device"] / 2**30, r["fits_80GB"]))


if __name__ == "__main__":
    report(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun")
