"""Tensor parallelism on the model axis: the port on two gloo ranks of a
(1, 2) ``data, model`` mesh (``tests/torch_ranks.py tp``), where the model
axis splits the work, against the one-process port on the same params, in
fp32 at 1e-5, and against the JAX package's GSPMD steps on a (1, 2) mesh
of forced host devices (``tests/jax_mesh_runs.py``, one subprocess beside
the ranks) on the same params.

The runs cover the five block families and the guard's fallbacks to whole
values: qwen3-8b (dense GQA, qk-norm, local kv heads), gemma-2b (one kv
head gathered whole from its split columns, tied embeddings; also with an
int8 cache), mixtral-8x22b (experts split, a windowed ring), hymba-1.5b
(the SSM branch's channels split, and with 5 q heads, which the guard
keeps whole as it does hymba's 25) and rwkv6-7b (K4's heads split). Each
run prefills, decodes four fed tokens, and takes the loss and the
gradients, through steps given placed params and no sharding context (they
install the mesh's own); ``greedy_generate`` does the same on the prompt.
No leaf sharded on the model axis is gathered whole inside those steps.
One launch of two ranks and one JAX subprocess serve the whole module."""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import torch_ranks  # noqa: E402

from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.train.serve_step import greedy_generate  # noqa: E402
from repro_torch.train.train_step import make_grad_fn  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT = 300
TOL = dict(rtol=1e-5, atol=1e-5)
# rwkv6-7b against JAX at tests/test_torch_rwkv.py's port-to-JAX 1e-4: on
# one device the port's embedding gradient and JAX's differ by 3.6 times
# the 1e-5 bound, and JAX's own wkv states on one device and on the (1, 2)
# mesh by 1.1 times it; the ranks equal the one-process port at 1e-5
RWKV_JAX_TOL = dict(rtol=1e-4, atol=1e-4)
RUNS = {
    "qwen3-8b": {"arch": "qwen3-8b"},
    "gemma-2b": {"arch": "gemma-2b"},
    "gemma-2b int8": {"arch": "gemma-2b", "opts": {"kv_quantized": True}},
    "mixtral-8x22b": {"arch": "mixtral-8x22b"},
    "hymba-1.5b": {"arch": "hymba-1.5b"},
    "hymba-1.5b whole q": {"arch": "hymba-1.5b", "cfg": {"n_heads": 5, "n_kv_heads": 1}},
    "rwkv6-7b": {"arch": "rwkv6-7b"},
}
PROMPT, FEED, BATCH, SEQ = 40, 4, 2, 16  # the prompt passes the smoke window of 32


def _run(name: str, seed: int) -> dict:
    run = dict(RUNS[name])
    cfg = torch_ranks.tp_config(run)
    rng = np.random.default_rng(seed)
    tok = lambda *shape: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape))  # noqa: E731
    run["params"] = build_model(cfg).init(torch.Generator().manual_seed(seed))
    run["prompt"], run["feed"] = tok(BATCH, PROMPT), tok(BATCH, FEED)
    run["batch"] = {"tokens": tok(BATCH, SEQ), "labels": tok(BATCH, SEQ)}
    return run


def _one_process(run: dict) -> dict:
    """The run's steps on one process: the reference."""
    cfg = torch_ranks.tp_config(run)
    model = build_model(cfg, ModelOptions(**{**torch_ranks.MODEL_OPTS, **run.get("opts", {})}))
    params, prompt, feed = run["params"], run["prompt"], run["feed"]
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": prompt},
                                      max_len=prompt.shape[1] + feed.shape[1])
        out = {"logits": [logits]}
        for i in range(feed.shape[1]):
            logits, cache = model.decode(params, {"tokens": feed[:, i : i + 1]}, cache,
                                         prompt.shape[1] + i)
            out["logits"].append(logits)
    out["cache"] = cache
    out["greedy"] = greedy_generate(model, params, {"tokens": prompt}, FEED,
                                    prompt.shape[1] + feed.shape[1])
    loss, out["grads"] = make_grad_fn(model)(params, run["batch"])
    out["loss"] = float(loss)
    return out


def _jax_inputs(run: dict) -> dict:
    """``run`` for ``tests/jax_mesh_runs.py``: numpy params, int32 tokens."""
    to_np = lambda t: t.numpy().astype(np.int32) if t.dtype == torch.int64 else t.numpy()  # noqa: E731
    return {"arch": run["arch"], "cfg": run.get("cfg", {}),
            "opts": {**torch_ranks.MODEL_OPTS, **run.get("opts", {})},
            **torch.utils._pytree.tree_map(to_np, {k: run[k] for k in ("params", "prompt", "feed",
                                                                      "batch")})}


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every run's results: the ranks', the one-process port's and JAX's."""
    workdir = tmp_path_factory.mktemp("tp")
    runs = {name: _run(name, seed) for seed, name in enumerate(RUNS)}
    torch.save({"runs": runs}, workdir / "inputs.pt")
    jax_in = {"tp": {name: _jax_inputs(run) for name, run in runs.items()}}
    (workdir / "jax_inputs.pkl").write_bytes(pickle.dumps(jax_in))
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen([sys.executable, str(ROOT / "tests" / "jax_mesh_runs.py"), str(workdir)],
                            env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        ranks = torch_ranks.launch("tp", 2, workdir, timeout=TIMEOUT)
        one = {name: _one_process(run) for name, run in runs.items()}
        log = proc.communicate(timeout=TIMEOUT)[0]
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    jx = pickle.loads((workdir / "jax_out.pkl").read_bytes())["tp"]
    return {name: (ranks[name], one[name], jx[name]) for name in runs}


def _jax_tol(name: str) -> dict:
    return RWKV_JAX_TOL if RUNS[name]["arch"] == "rwkv6-7b" else TOL


def _close(a, b, what: str, tol=TOL) -> None:
    as_np = lambda t: t.detach().float().numpy() if isinstance(t, torch.Tensor) else t  # noqa: E731
    np.testing.assert_allclose(as_np(a), np.asarray(as_np(b), np.float32), **tol, err_msg=what)


@pytest.mark.parametrize("name", list(RUNS))
def test_prefill_and_decode_logits_match_one_process(tp, name):
    ours, ref, _ = tp[name]
    assert len(ours["logits"]) == len(ref["logits"]) == FEED + 1
    for i, (a, b) in enumerate(zip(ours["logits"], ref["logits"])):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        _close(a, b, f"logits of step {i}")


@pytest.mark.parametrize("name", list(RUNS))
def test_cache_after_decode_matches_one_process(tp, name):
    """The ranks' cache, laid out by ``cache_shardings``, gathered whole."""
    ours, ref, _ = tp[name]
    assert set(ours["cache"]) == set(ref["cache"])
    for leaf, t in ref["cache"].items():
        assert ours["cache"][leaf].dtype == t.dtype, leaf
        _close(ours["cache"][leaf].float(), t.float(), leaf)


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_and_gradients_match_one_process(tp, name):
    ours, ref, _ = tp[name]
    np.testing.assert_allclose(ours["loss"], ref["loss"], **TOL)
    flat_ours = dict(torch.utils._pytree.tree_flatten_with_path(ours["grads"])[0])
    flat_ref = dict(torch.utils._pytree.tree_flatten_with_path(ref["grads"])[0])
    assert flat_ours.keys() == flat_ref.keys()
    for path, g in flat_ref.items():
        _close(flat_ours[path], g, str(path))


@pytest.mark.parametrize("name", list(RUNS))
def test_no_model_sharded_leaf_is_gathered_whole(tp, name):
    assert tp[name][0]["model_sharded_gathers"] == 0


@pytest.mark.parametrize("name", list(RUNS))
def test_greedy_generate_matches_one_process(tp, name):
    ours, ref, _ = tp[name]
    assert torch.equal(ours["greedy"], ref["greedy"]), (ours["greedy"], ref["greedy"])


@pytest.mark.parametrize("name", list(RUNS))
def test_prefill_and_decode_match_jax_gspmd(tp, name):
    """The ranks' logits of each step and the cache after the last against
    JAX's prefill and decode steps on a (1, 2) mesh."""
    ours, _, jx = tp[name]
    tol = _jax_tol(name)
    assert len(ours["logits"]) == len(jx["logits"]) == FEED + 1
    for i, (a, b) in enumerate(zip(ours["logits"], jx["logits"])):
        assert tuple(a.shape) == b.shape, (i, a.shape, b.shape)
        _close(a, b, f"logits of step {i}", tol)
    assert set(ours["cache"]) == set(jx["cache"])
    for leaf, t in jx["cache"].items():
        assert tuple(ours["cache"][leaf].shape) == t.shape, leaf
        assert str(ours["cache"][leaf].dtype)[6:] == str(t.dtype), leaf
        _close(ours["cache"][leaf], t, leaf, tol)


@pytest.mark.parametrize("name", list(RUNS))
def test_loss_and_gradients_match_jax_gspmd(tp, name):
    """The ranks' loss and gradients, gathered whole, against JAX's
    ``value_and_grad`` of the loss on a (1, 2) mesh."""
    ours, _, jx = tp[name]
    tol = _jax_tol(name)
    np.testing.assert_allclose(ours["loss"], jx["loss"], **tol)
    flat_ours = dict(torch.utils._pytree.tree_flatten_with_path(ours["grads"])[0])
    flat_jax = dict(torch.utils._pytree.tree_flatten_with_path(jx["grads"])[0])
    assert flat_ours.keys() == flat_jax.keys()
    for path, g in flat_jax.items():
        _close(flat_ours[path], g, str(path), tol)
