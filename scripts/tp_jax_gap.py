#!/usr/bin/env python3
"""How far apart the one-process port, the JAX package on one device and
the JAX package on a (1, 2) ``data, model`` mesh are for a run of
``tests/test_torch_tp.py``, on the CPU; needs JAX and torch:

    PYTHONPATH=src:tests JAX_PLATFORMS=cpu python3 scripts/tp_jax_gap.py [RUN ...]

RUN names a run of ``test_torch_tp.RUNS`` (default: rwkv6-7b). For each,
on that test's inputs, it runs the port in one process, JAX's jitted
prefill, decode and ``value_and_grad(model.loss)`` on one device, and
``tests/jax_mesh_runs.py``'s ``tp`` case (the (1, 2) mesh, a subprocess
with forced host devices), and prints one JSON line a pair of sides: for
the cache after the last decode step and for the gradients, the worst
element's gap as a multiple of the test's 1e-5 bound (``|a - b| / (1e-5 +
1e-5 |b|)``; above 1 fails it) and its leaf, and the two losses.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
from dataclasses import replace
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from torch.utils import _pytree as pytree

import test_torch_tp as harness
from repro.configs import get_config
from repro.models import ModelOptions, build_model

ROOT = Path(__file__).resolve().parents[1]


def worst(a, b) -> list:
    """The largest ``|a - b| / (1e-5 + 1e-5 |b|)`` over the leaves, and its leaf."""
    flat_b = dict(pytree.tree_flatten_with_path(b)[0])
    out = [0.0, None]
    for path, x in pytree.tree_flatten_with_path(a)[0]:
        x = np.asarray(x.detach().numpy() if hasattr(x, "detach") else x, np.float64)
        y = np.asarray(flat_b[path], np.float64)
        err = float(np.max(np.abs(x - y) / (1e-5 + 1e-5 * np.abs(y))))
        if err > out[0]:
            out = [err, pytree.keystr(path)]
    return out


def jax_one_device(run: dict) -> dict:
    cfg = replace(get_config(run["arch"]).smoke(), **run["cfg"])
    model = build_model(cfg, ModelOptions(**run["opts"]))
    params = jax.tree_util.tree_map(jnp.asarray, run["params"])
    prompt, feed = run["prompt"], run["feed"]
    s = prompt.shape[1]
    _, cache = jax.jit(lambda p, b: model.prefill(p, b, max_len=s + feed.shape[1]))(
        params, {"tokens": jnp.asarray(prompt)})
    decode = jax.jit(model.decode)
    for i in range(feed.shape[1]):
        _, cache = decode(params, {"tokens": jnp.asarray(feed[:, i : i + 1])}, cache,
                          jnp.asarray(s + i, jnp.int32))
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        params, {k: jnp.asarray(v) for k, v in run["batch"].items()})
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"cache": host(cache), "loss": float(loss), "grads": host(grads)}


def main() -> None:
    names = sys.argv[1:] or ["rwkv6-7b"]
    runs = {name: harness._run(name, list(harness.RUNS).index(name)) for name in names}
    jax_in = {name: harness._jax_inputs(run) for name, run in runs.items()}
    with tempfile.TemporaryDirectory() as workdir:
        (Path(workdir) / "jax_inputs.pkl").write_bytes(pickle.dumps({"tp": jax_in}))
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        env.pop("XLA_FLAGS", None)
        subprocess.run([sys.executable, str(ROOT / "tests" / "jax_mesh_runs.py"), workdir],
                       check=True, env=env, cwd=ROOT)
        mesh = pickle.loads((Path(workdir) / "jax_out.pkl").read_bytes())["tp"]
    for name, run in runs.items():
        sides = {"port": harness._one_process(run), "jax_one_device": jax_one_device(jax_in[name]),
                 "jax_mesh": mesh[name]}
        for a, b in (("jax_mesh", "jax_one_device"), ("port", "jax_one_device"),
                     ("port", "jax_mesh")):
            print(json.dumps({"run": name, "pair": [a, b],
                              "cache": worst(sides[a]["cache"], sides[b]["cache"]),
                              "grads": worst(sides[a]["grads"], sides[b]["grads"]),
                              "loss": [sides[a]["loss"], sides[b]["loss"]]}))


if __name__ == "__main__":
    main()
