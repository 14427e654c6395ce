"""Port serve driver on the CPU: every request is served; a service's
handle, fed the JAX service's params, gives the JAX handle's next tokens;
request streams and seeds match the JAX driver; the device is the card
unless the caller asks for the CPU. mixtral-8x22b (MoE, routing groups of
16 as in the JAX driver) serves and trains beside them, and so does
hymba-1.5b (SSM chunks of 8, as in the JAX driver)."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.device import device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

ARCHS = ["gemma-2b", "qwen3-8b", "rwkv6-7b"]  # the JAX driver's default list
ARGV = ["--device", "cpu", "--smoke", "--archs", ",".join(ARCHS),
        "--rps", "4", "--duration", "1", "--requests", "3", "--policy", "priority"]


def test_serve_main_serves_every_request():
    report, ex = serve.serve(serve.build_parser().parse_args(ARGV))
    assert not report.failures
    assert {s.name for s in ex.sessions.values()} == set(ARCHS)
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        assert sess.n_iters > 0 and st.iterations_done == sess.n_iters
        assert len(st.request_latencies) == sess.n_iters
        for m in sess.metrics_log:
            assert m["next_token"].shape == (serve.PROMPT_SHAPE[0],)
    assert serve.main(ARGV).failures == {}


def test_train_background_runs():
    """``--train-background`` co-locates a trainer with the services;
    every request is served, the trainer takes gradient steps and nothing
    fails."""
    # a long window: the run ends when the sessions finish, not at the
    # serve loop's wall cap (duration + 5 s), however loaded the host
    report, ex = serve.serve(serve.build_parser().parse_args(
        ARGV + ["--train-background", "gemma-2b", "--train-iters", "4", "--duration", "60"]))
    assert not report.failures
    trainer = [s for s in ex.sessions.values() if s.job.kind == "train"]
    assert [s.name for s in trainer] == ["train:gemma-2b"]
    assert report.stats[trainer[0].job.job_id].iterations_done == 4
    losses = [float(m["loss"]) for m in trainer[0].metrics_log]
    assert len(losses) == 4 and all(np.isfinite(losses))
    for jid, st in report.stats.items():
        assert st.iterations_done == ex.sessions[jid].n_iters


def test_moe_service_beside_a_moe_trainer():
    """``--archs mixtral-8x22b --smoke --train-background mixtral-8x22b``:
    every request served, the trainer's losses finite, nothing fails."""
    report, ex = serve.serve(serve.build_parser().parse_args(
        ARGV + ["--archs", "mixtral-8x22b", "--train-background", "mixtral-8x22b",
                "--train-iters", "2", "--duration", "60"]))
    assert not report.failures
    assert sorted(s.name for s in ex.sessions.values()) == ["mixtral-8x22b", "train:mixtral-8x22b"]
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        assert st.iterations_done == sess.n_iters > 0
        if sess.job.kind == "train":
            assert all(np.isfinite(float(m["loss"])) for m in sess.metrics_log)
        else:
            assert all(m["next_token"].shape == (serve.PROMPT_SHAPE[0],) for m in sess.metrics_log)


def test_hymba_service_beside_gemma():
    """``--archs hymba-1.5b,gemma-2b``: the hybrid family on the serving
    path, every request served; each next token is the argmax of the
    service's own prefill of that request."""
    report, ex = serve.serve(serve.build_parser().parse_args(
        ARGV + ["--archs", "hymba-1.5b,gemma-2b"]))
    assert not report.failures
    assert sorted(s.name for s in ex.sessions.values()) == ["gemma-2b", "hymba-1.5b"]
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        assert st.iterations_done == sess.n_iters > 0
        if sess.name == "hymba-1.5b":
            assert "ssm" in sess.state["layers"]
            handle, _, data_fn = serve.make_service("hymba-1.5b", smoke=True, device="cpu")
            _, out = handle(sess.state, data_fn(0))
            assert torch.equal(out["next_token"], sess.metrics_log[0]["next_token"])


def test_serve_takes_a_config_in_place_of_the_registry():
    """``serve(args, configs)`` serves a given config under a service's
    name (how a full-width model is cut in depth to fit one card)."""
    cfg = dataclasses.replace(serve.get_config("mixtral-8x22b").smoke(), n_layers=1)
    report, ex = serve.serve(serve.build_parser().parse_args(
        ARGV + ["--archs", "mixtral-8x22b,gemma-2b"]), configs={"mixtral-8x22b": cfg})
    assert not report.failures
    layers = {s.name: s.state["layers"]["attn_norm"]["scale"].shape[0]
              for s in ex.sessions.values()}
    assert layers == {"mixtral-8x22b": 1, "gemma-2b": 2}


def test_train_background_report_prints_iterations(capsys):
    serve.main(ARGV + ["--archs", "gemma-2b", "--train-background", "qwen3-8b",
                       "--train-iters", "2", "--duration", "60"])
    out = capsys.readouterr().out
    assert "+ background training qwen3-8b" in out
    assert "train:qwen3-8b: 2 training iterations (" in out and "boundary preemptions)" in out


@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x22b", "hymba-1.5b"])
def test_trainer_step_matches_jax(arch, monkeypatch):
    """The trainer's step on the JAX trainer's params and batch gives JAX's
    loss and new params (fp32 compute on both sides)."""
    monkeypatch.setattr(
        jax_serve, "_MODEL_OPTS", dataclasses.replace(jax_serve._MODEL_OPTS, compute_dtype="float32")
    )
    jstep, jparams, jdata = jax_serve.make_trainer(arch, smoke=True)
    step, _, data_fn = serve.make_trainer(
        arch, smoke=True, device="cpu",
        opts=dataclasses.replace(serve.TRAIN_OPTS, compute_dtype="float32"),
    )
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    batch = jdata(1)
    jnew, jm = jax.jit(jstep)(jparams, batch)
    new, m = step(params, {k: torch.from_numpy(np.array(v)).long() for k, v in batch.items()})
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    for path, a in jax.tree_util.tree_leaves_with_path(jnew):
        t = new
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=1e-5, atol=1e-7)
    # functional: the old params are untouched, labels are the rolled tokens
    assert all(torch.equal(a, b) for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(
        from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu"))))
    b = data_fn(3)
    assert b["tokens"].shape == serve.TRAIN_SHAPE
    assert torch.equal(b["labels"], torch.roll(b["tokens"], -1, dims=-1))
    assert serve.TRAIN_OPTS.loss_chunk == jax_serve._MODEL_OPTS.loss_chunk


@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x22b", "hymba-1.5b"])
def test_handle_gives_jax_next_tokens(arch, monkeypatch):
    """Each driver's own service options, in fp32 on both sides, so the
    argmax compares the algorithm and not where the two frameworks round
    bf16."""
    monkeypatch.setattr(
        jax_serve, "_MODEL_OPTS", dataclasses.replace(jax_serve._MODEL_OPTS, compute_dtype="float32")
    )
    jhandle, jparams, jdata = jax_serve.make_service(arch, smoke=True)
    handle, _, _ = serve.make_service(
        arch, smoke=True, device="cpu",
        opts=dataclasses.replace(serve.SERVE_OPTS, compute_dtype="float32"),
    )
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    for i in range(3):
        tokens = np.array(jdata(i)["tokens"])
        _, jout = jhandle(jparams, {"tokens": tokens})
        state, out = handle(params, {"tokens": torch.from_numpy(tokens).long()})
        assert state is params
        np.testing.assert_array_equal(out["next_token"].numpy(), np.asarray(jout["next_token"]))


def test_requests_and_seeds_match_jax():
    for seed in (0, 5):
        ours = serve.poisson_requests(4.0, 3.0, random.Random(seed))
        theirs = jax_serve.poisson_requests(4.0, 3.0, random.Random(seed))
        assert ours == theirs and len(ours) > 0
    for name in ARCHS:
        assert serve.stable_seed(name) == jax_serve.stable_seed(name)
    assert serve.build_parser().parse_args([]).archs == ",".join(ARCHS)
    assert serve.SERVE_OPTS.wkv_chunk == jax_serve._MODEL_OPTS.wkv_chunk
    for opts in (serve.SERVE_OPTS, serve.TRAIN_OPTS):
        assert opts.moe_group == jax_serve._MODEL_OPTS.moe_group == 16
        assert opts.ssm_chunk == jax_serve._MODEL_OPTS.ssm_chunk == 8


def test_service_is_deterministic_in_its_seeds():
    h1, p1, d1 = serve.make_service("gemma-2b", smoke=True, device="cpu")
    h2, p2, d2 = serve.make_service("gemma-2b", smoke=True, device="cpu")
    assert torch.equal(p1["embed"]["table"], p2["embed"]["table"])
    assert torch.equal(d1(3)["tokens"], d2(3)["tokens"])
    assert not torch.equal(d1(3)["tokens"], d1(4)["tokens"])
    assert torch.equal(h1(p1, d1(0))[1]["next_token"], h2(p2, d2(0))[1]["next_token"])


def test_device_is_the_card_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device()
    with pytest.raises(RuntimeError):
        device("cuda")
    assert device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError):
        serve.main(["--smoke", "--requests", "1"])  # --device defaults to cuda
