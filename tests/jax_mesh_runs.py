"""The JAX package's side of ``tests/test_torch_launch_train.py`` and
``tests/test_torch_tp.py``, run in a subprocess of its own with four
forced host devices (the flag must never reach the pytest process, whose
suite sees one device):

    python tests/jax_mesh_runs.py <workdir>

Reads ``<workdir>/jax_inputs.pkl`` and writes ``<workdir>/jax_out.pkl``:
  * ``steps``: for each arch, JAX's sharded train step on a (2, 2)
    ``data, model`` mesh (``make_train_step`` under ``jax.jit`` with the
    sharding rules), from ``Model.init(PRNGKey(0))`` on the given batch;
    the result is the loss, the grad norm, the MoE aux loss of each global
    microbatch (rows ``j, n + j, ...``) before the step, and the params and
    AdamW ``m`` and ``v`` after it, as numpy trees.
  * ``cli``: for each run, ``repro.launch.train.main(argv)`` with its
    printed lines. ``fp32`` runs it with fp32 compute (``ModelOptions``
    with ``compute_dtype="float32"`` in the CLI's namespace).
  * ``tp``: for each run, on a (1, 2) ``data, model`` mesh of two of the
    devices, with the run's params (numpy, the port's layout) and
    ``ModelOptions``: the prefill of ``prompt`` (``make_prefill_step``
    under ``jax.jit``, params placed by ``param_shardings(serve=True)``),
    then ``feed``'s tokens decoded one at a time (``make_decode_step``
    under ``jax.jit``, the cache placed by ``cache_shardings``), then the
    loss and gradients of ``batch`` (``jax.value_and_grad(model.loss)``
    under ``jax.jit``, params placed by ``param_shardings``): the logits
    of each step, the cache after the last, the loss and the gradients,
    as numpy.
"""
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import functools  # noqa: E402
import io  # noqa: E402
import pickle  # noqa: E402
from pathlib import Path  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.dist.api import use_sharding  # noqa: E402
from repro.dist.sharding import (  # noqa: E402
    batch_shardings,
    cache_shardings,
    make_context,
    param_shardings,
)
from repro.launch.mesh import make_mesh  # noqa: E402
from repro.models import ModelOptions, build_model  # noqa: E402
from repro.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro.train.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from repro.train.train_step import TrainRunConfig, make_train_step  # noqa: E402

MESH, TP_MESH, AXES = (2, 2), (1, 2), ("data", "model")


def sharded_step(arch: str, run: dict) -> dict:
    cfg = get_config(arch).smoke()
    mesh = make_mesh(MESH, AXES)
    model = build_model(cfg, ModelOptions(**run["opts"]))
    opt = AdamW(AdamWConfig(**run["adamw"]))
    n = run["microbatches"]
    b, s = run["batch"]["labels"].shape
    with mesh, use_sharding(make_context(mesh, cfg)):
        params = model.init(jax.random.PRNGKey(0))
        params = jax.device_put(params, param_shardings(params, cfg, mesh))
        state = opt.init(params)
        state = jax.device_put(state, param_shardings(state, cfg, mesh))

        def placed(batch, rows):
            sh = batch_shardings(cfg, ShapeConfig("t", "train", s, rows), mesh)
            return {k: jax.device_put(jnp.asarray(v), sh[k]) for k, v in batch.items()}

        aux = jax.jit(lambda p, mb: model.apply(p, mb)[1])
        auxes = [float(aux(params, placed({k: v[j::n] for k, v in run["batch"].items()}, b // n)))
                 for j in range(n)]
        step = jax.jit(make_train_step(model, opt, TrainRunConfig(num_microbatches=n)))
        params, state, metrics = step(params, state, placed(run["batch"], b))
    host = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
            "aux": auxes, "params": host(params), "m": host(state["m"]), "v": host(state["v"])}


def tp_run(run: dict) -> dict:
    cfg = dataclasses.replace(get_config(run["arch"]).smoke(), **run["cfg"])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]).reshape(TP_MESH), AXES)
    model = build_model(cfg, ModelOptions(**run["opts"]))
    prompt, feed = run["prompt"], run["feed"]
    b, s = prompt.shape
    host = functools.partial(jax.tree_util.tree_map, np.asarray)
    with mesh, use_sharding(make_context(mesh, cfg)):

        def placed(batch):
            rows = batch_shardings(cfg, ShapeConfig("t", "train", batch["tokens"].shape[1], b), mesh)
            return {k: jax.device_put(jnp.asarray(v), rows[k]) for k, v in batch.items()}

        params = jax.tree_util.tree_map(jnp.asarray, run["params"])
        served = jax.device_put(params, param_shardings(params, cfg, mesh, serve=True))
        prefill = jax.jit(make_prefill_step(model, s + feed.shape[1]))
        logits, cache = prefill(served, placed({"tokens": prompt}))
        c_sh = cache_shardings(cache, cfg, ShapeConfig("prefill", "prefill", s, b), mesh)
        cache = jax.device_put(cache, c_sh)
        decode = jax.jit(make_decode_step(model), out_shardings=(None, c_sh))
        out = {"logits": [host(logits)]}
        for i in range(feed.shape[1]):
            logits, cache = decode(served, placed({"tokens": feed[:, i : i + 1]}), cache,
                                   jnp.asarray(s + i, jnp.int32))
            out["logits"].append(host(logits))
        trained = jax.device_put(params, param_shardings(params, cfg, mesh))
        loss, grads = jax.jit(jax.value_and_grad(model.loss))(trained, placed(run["batch"]))
    return {**out, "cache": host(cache), "loss": float(loss), "grads": host(grads)}


def cli(run: dict) -> str:
    import repro.launch.train as cli_mod

    out = io.StringIO()
    opts = cli_mod.ModelOptions
    if run.get("fp32"):
        cli_mod.ModelOptions = functools.partial(opts, compute_dtype="float32")
    try:
        with contextlib.redirect_stdout(out):
            cli_mod.main(run["argv"])
    finally:
        cli_mod.ModelOptions = opts
    return out.getvalue()


def main() -> None:
    os.nice(19)  # under xdist, yield the cores to the suite's workers, as the gloo ranks do
    workdir = Path(sys.argv[1])
    inputs = pickle.loads((workdir / "jax_inputs.pkl").read_bytes())
    assert len(jax.devices()) == 4, jax.devices()
    out = {"steps": {arch: sharded_step(arch, run) for arch, run in inputs.get("steps", {}).items()},
           "cli": {name: cli(run) for name, run in inputs.get("cli", {}).items()},
           "tp": {name: tp_run(run) for name, run in inputs.get("tp", {}).items()}}
    (workdir / "jax_out.pkl").write_bytes(pickle.dumps(out))


if __name__ == "__main__":
    main()
