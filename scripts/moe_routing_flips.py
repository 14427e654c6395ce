#!/usr/bin/env python3
"""Router flips between numerics in the port's MoE prefill, on the GPU.

    python3 scripts/moe_routing_flips.py

mixtral-8x22b at (1, 6144) and qwen3-moe-235b-a22b at (1, 512), full
width, 4 layers, fp32 params from a fixed seed (``chip_smoke.py``'s parity
draw), prefilled at routing groups of 8 tokens (capacity covers the group:
nothing is dropped) and of 4096 (the default), through the kernels and
the plain versions in bf16 and fp32. For three pairs of runs (kernels
against plain in bf16 and in fp32, plain bf16 against plain fp32) it
prints the last-token logits' largest gap, each run's dropped
assignments, and the tokens sent to another set of experts in each route
call, with whether the last token was among them; and the plain fp32
run's routing skew: the share of assignments its busiest expert takes and
the share of tokens on the most common expert set, a route call each.
One JSON line a (config, group).
"""
from __future__ import annotations

import gc
import json
import sys
from dataclasses import replace
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]  # the port, and chip_smoke's routing trace

PAIRS = ((("kernel", "bfloat16"), ("reference", "bfloat16")),
         (("reference", "bfloat16"), ("reference", "float32")),
         (("kernel", "float32"), ("reference", "float32")))


def main() -> int:
    if not torch.cuda.is_available():
        print("moe_routing_flips: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from chip_smoke import dropped, moe_trace
    from repro_torch.models import ModelOptions, build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    for arch, seq in (("mixtral-8x22b", 6144), ("qwen3-moe-235b-a22b", 512)):
        cfg = replace(get_config(arch), n_layers=4)
        gen = torch.Generator(device="cuda").manual_seed(8)
        params = build_model(cfg).init(gen)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                                         device="cuda")}
        for group in (8, 4096):
            runs = {}
            for dtype in ("float32", "bfloat16"):
                for mode in ("reference", "kernel"):
                    model = build_model(cfg, ModelOptions(
                        kernel_mode=mode, compute_dtype=dtype, moe_group=group,
                        attn_q_chunk=1024))
                    with moe_trace() as log:
                        logits, _ = model.prefill(params, batch)
                    sets = [r.experts.reshape(-1, cfg.top_k).sort(-1).values for r in log]
                    runs[mode, dtype] = (logits.float(), sets, dropped(log))
            out = {"arch": arch, "n_layers": cfg.n_layers, "prompt": [1, seq], "group": group}
            for a, b in PAIRS:
                (la, ra, da), (lb, rb, db) = runs[a], runs[b]
                out[f"{a[0]} {a[1]} vs {b[0]} {b[1]}"] = {
                    "logits_max_abs_diff": (la - lb).abs().max().item(),
                    "dropped_assignments": [da, db],
                    "flipped_tokens_a_route_call":
                        [int((x != y).any(-1).sum().item()) for x, y in zip(ra, rb)],
                    "last_token_flipped_a_route_call":
                        [bool((x[-1] != y[-1]).any().item()) for x, y in zip(ra, rb)],
                }
            sets = runs["reference", "float32"][1]
            load = [torch.bincount(s.flatten(), minlength=cfg.n_experts).float() for s in sets]
            out["plain_fp32_busiest_expert_share"] = [float(x.max() / x.sum()) for x in load]
            out["plain_fp32_most_common_set_share"] = [
                float((s == s.mode(0).values).all(-1).float().mean()) for s in sets]
            print(json.dumps(out), flush=True)
        del params, runs
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
