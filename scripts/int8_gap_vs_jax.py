#!/usr/bin/env python3
"""hymba-1.5b's int8 KV cache against its bf16 cache, in the JAX package and
in the port, on the same params and tokens (ROADMAP queue C, C1).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/int8_gap_vs_jax.py

It needs both packages, so it runs on a machine with JAX and the CPU build
of torch (about 13 minutes on 8 cores; a few GB of memory). Protocol:

* full-width, full-depth hymba-1.5b, params from the JAX package's
  ``Model.init(jax.random.PRNGKey(18))``, cast to bf16, and the port's copy
  of them through ``repro_torch.weights.from_jax`` (bit for bit);
* the runtime tables' decode options (``model_options_for(DECODE_32K)``:
  bf16 params and compute) with the plain paths (JAX
  ``kernel_mode="reference"``; the port's CPU wrappers take their plain
  versions), once with a bf16 cache and once with an int8 cache;
* a 2560-token prompt from ``jax.random.randint(PRNGKey(19))`` (past the
  1024-token window, so the ring wraps), prefilled into a cache of
  2560 + 16, then 15 decode steps fed the tokens that JAX's bf16-cache run
  picks greedily. Every run sees the same 16 inputs.

``rel(a, b)`` is max |a - b| over max |b| across the 16 steps' logits. It
prints one JSON line: the JAX gap (int8 against bf16 cache), the port's
gap, the port's bf16-cache logits against JAX's (the two implementations'
own bf16 distance), the worst single step of each gap (that step's
``rel``), and the rule's verdict: C1 closes when |port gap - JAX gap| <=
the bf16 distance.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import DECODE_32K as JAX_DECODE_32K  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train.runtime import model_options_for as jax_options_for  # noqa: E402
from repro_torch.configs import DECODE_32K, get_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.train.runtime import model_options_for  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

ARCH = "hymba-1.5b"
PROMPT = 2560
NEW = 16


def jax_run(cfg, params, prompt, quantized, feed=None):
    """Prefill ``prompt`` and decode ``NEW - 1`` steps fed ``feed`` (or
    greedily): (tokens (NEW,), fp32 logits (NEW, vocab))."""
    opts = dataclasses.replace(jax_options_for(cfg, JAX_DECODE_32K, kernel_mode="reference"),
                               kv_quantized=quantized)
    model = jax_build_model(cfg, opts)
    prefill = jax.jit(lambda p, b: model.prefill(p, b, max_len=PROMPT + NEW))
    decode = jax.jit(model.decode)
    logits, cache = prefill(params, {"tokens": prompt})
    outs = [np.asarray(logits[0].astype(jnp.float32))]
    toks = [int(np.argmax(outs[-1]))]
    for i in range(NEW - 1):
        tok = toks[-1] if feed is None else int(feed[i])
        logits, cache = decode(params, {"tokens": jnp.asarray([[tok]], jnp.int32)}, cache,
                               jnp.asarray(PROMPT + i, jnp.int32))
        outs.append(np.asarray(logits[0, -1].astype(jnp.float32)))
        toks.append(int(np.argmax(outs[-1])))
    return np.array(toks), np.stack(outs)


def port_run(cfg, params, prompt, quantized, feed):
    """The port's plain path on the CPU, fed ``feed``: fp32 logits (NEW, vocab)."""
    opts = dataclasses.replace(model_options_for(cfg, DECODE_32K, kernel_mode="reference"),
                               kv_quantized=quantized)
    model = build_model(cfg, opts)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt}, max_len=PROMPT + NEW)
        outs = [logits[0].float().numpy()]
        for i in range(NEW - 1):
            tok = torch.tensor([[int(feed[i])]], dtype=torch.long)
            logits, cache = model.decode(params, {"tokens": tok}, cache, PROMPT + i)
            outs.append(logits[0, -1].float().numpy())
    return np.stack(outs)


def rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def worst_step(a, b):
    """The largest of the steps' own ``rel`` (each over its own max |logit|)."""
    return float(max(rel(x, y) for x, y in zip(a, b)))


def main() -> int:
    t0 = time.perf_counter()
    jcfg = jax_get_config(ARCH)
    cfg = get_config(ARCH)
    init_model = jax_build_model(jcfg, jax_options_for(jcfg, JAX_DECODE_32K))
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16),
                                     init_model.init(jax.random.PRNGKey(18)))
    prompt = jax.random.randint(jax.random.PRNGKey(19), (1, PROMPT), 0, jcfg.vocab_size)
    j16_tok, j16 = jax_run(jcfg, jparams, prompt, quantized=False)
    _, j8 = jax_run(jcfg, jparams, prompt, quantized=True, feed=j16_tok)
    t_jax = time.perf_counter() - t0
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    del jparams
    tprompt = torch.from_numpy(np.array(prompt)).long()
    p16 = port_run(cfg, params, tprompt, quantized=False, feed=j16_tok)
    p8 = port_run(cfg, params, tprompt, quantized=True, feed=j16_tok)
    jax_gap, port_gap, distance = rel(j8, j16), rel(p8, p16), rel(p16, j16)
    print(json.dumps({
        "arch": ARCH, "prompt": PROMPT, "new_tokens": NEW, "fed_tokens": j16_tok.tolist(),
        "jax_int8_vs_bf16_cache": jax_gap, "jax_worst_step": worst_step(j8, j16),
        "port_int8_vs_bf16_cache": port_gap, "port_worst_step": worst_step(p8, p16),
        "port_bf16_vs_jax_bf16": distance,
        "gap_difference": abs(port_gap - jax_gap),
        "c1_closes": abs(port_gap - jax_gap) <= distance,
        "jax_seconds": t_jax, "seconds": time.perf_counter() - t0,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
