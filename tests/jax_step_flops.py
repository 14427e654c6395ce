"""The JAX package's side of ``tests/test_torch_dryrun.py``: the FLOPs
``launch/hlo_flops.py::analyze_hlo`` counts in gemma-2b's train, prefill
and decode steps at full width, cut to one layer, in fp32 on the
reference path, each lowered and compiled for one host device (nothing
is run). Run in a subprocess of its own:

    python tests/jax_step_flops.py

prints one JSON object, ``{"train": flops, "prefill": flops, "decode":
flops}``: a train step of (1, 512) tokens in one microbatch with AdamW, a
prefill of (1, 512), and one decode step at batch 4 from a 512-token
cache.
"""
import json
import os
import sys
from dataclasses import replace
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.launch.hlo_flops import analyze_hlo  # noqa: E402
from repro.models import ModelOptions, build_model  # noqa: E402
from repro.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro.train.serve_step import make_decode_step, make_prefill_step  # noqa: E402
from repro.train.train_step import TrainRunConfig, make_train_step  # noqa: E402

SEQ, DECODE_BATCH = 512, 4


def flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def main() -> None:
    cfg = replace(get_config("gemma-2b"), n_layers=1)
    opts = ModelOptions(kernel_mode="reference", compute_dtype="float32", param_dtype="float32")
    model = build_model(cfg, opts)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    tokens = jax.ShapeDtypeStruct((1, SEQ), jnp.int32)
    opt = AdamW(AdamWConfig())
    step = make_train_step(model, opt, TrainRunConfig(num_microbatches=1))
    out = {"train": flops(step, params, jax.eval_shape(opt.init, params),
                          {"tokens": tokens, "labels": tokens}),
           "prefill": flops(make_prefill_step(model, max_len=SEQ), params, {"tokens": tokens})}
    cache = jax.eval_shape(lambda: model.init_cache(DECODE_BATCH, SEQ))
    out["decode"] = flops(make_decode_step(model), params,
                          {"tokens": jax.ShapeDtypeStruct((DECODE_BATCH, 1), jnp.int32)}, cache,
                          jax.ShapeDtypeStruct((), jnp.int32))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
