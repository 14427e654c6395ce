#!/usr/bin/env python3
"""The gap between the port's train step on a (2, 2) ``data, model`` mesh
of gloo ranks and the JAX package's sharded step (``ROADMAP.md`` C2), on
the CPU; needs JAX and torch:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 scripts/moe_mesh_gap.py

Runs ``tests/test_torch_launch_train.py``'s launches (one JAX subprocess
with four forced host devices beside four gloo ranks: mixtral-8x22b smoke
and the dense control qwen3-8b smoke, fp32, a 4 x 16 batch of seed 3 in
two microbatches, MoE groups of 64 tokens, so each group spans both data
ranks) in a temporary directory, and prints one JSON line an arch: both
sides' loss, grad norm and aux loss of each microbatch (the port's on
every rank), and for params and AdamW ``m`` and ``v`` the largest
element gap (and its leaf) and the largest relative Frobenius gap of a
leaf.
"""
import json
import tempfile
from pathlib import Path

import numpy as np
from torch.utils import _pytree as pytree

import test_torch_launch_train as harness
from repro_torch.ckpt.checkpoint import _sorted


def gap(jax_tree, port_tree) -> dict:
    worst = {"max_abs": 0.0, "leaf": None, "max_rel_fro": 0.0}
    flat = pytree.tree_flatten_with_path(_sorted(jax_tree))[0]
    for (path, a), b in zip(flat, pytree.tree_leaves(_sorted(port_tree))):
        a, b = np.asarray(a, np.float64), b.double().numpy()
        err = float(np.abs(a - b).max())
        if err > worst["max_abs"]:
            worst.update(max_abs=err, leaf=pytree.keystr(path))
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))
        worst["max_rel_fro"] = max(worst["max_rel_fro"], rel)
    return worst


def main() -> None:
    with tempfile.TemporaryDirectory() as d:
        jax_out, port_out, _ = harness.launch_runs(Path(d))
    for arch, jx in jax_out["steps"].items():
        pt = port_out["steps"][arch]
        tree = _sorted(pt["tree"])
        print(json.dumps({
            "arch": arch, "loss": [jx["loss"], pt["loss"]],
            "loss_rel_gap": abs(pt["loss"] - jx["loss"]) / abs(jx["loss"]),
            "grad_norm": [jx["grad_norm"], pt["grad_norm"]],
            "grad_norm_rel_gap": abs(pt["grad_norm"] - jx["grad_norm"]) / abs(jx["grad_norm"]),
            "aux_jax": jx["aux"], "aux_port_by_rank": pt["aux"],
            "params": gap(jx["params"], tree["params"]), "m": gap(jx["m"], tree["opt"]["m"]),
            "v": gap(jx["v"], tree["opt"]["v"])}))


if __name__ == "__main__":
    main()
