"""Port serve driver on the CPU: every request is served; a service's
handle, fed the JAX service's params, gives the JAX handle's next tokens;
request streams and seeds match the JAX driver; the device is the card
unless the caller asks for the CPU."""
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro_torch.device import device  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import ModelOptions  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

ARGV = ["--device", "cpu", "--smoke", "--archs", "gemma-2b,qwen3-8b",
        "--rps", "4", "--duration", "1", "--requests", "3", "--policy", "priority"]


def test_serve_main_serves_every_request():
    report, ex = serve.serve(serve.build_parser().parse_args(ARGV))
    assert not report.failures
    assert {s.name for s in ex.sessions.values()} == {"gemma-2b", "qwen3-8b"}
    for jid, st in report.stats.items():
        sess = ex.sessions[jid]
        assert sess.n_iters > 0 and st.iterations_done == sess.n_iters
        assert len(st.request_latencies) == sess.n_iters
        for m in sess.metrics_log:
            assert m["next_token"].shape == (serve.PROMPT_SHAPE[0],)
    assert serve.main(ARGV).failures == {}


def test_train_background_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="training slice"):
        serve.main(ARGV + ["--train-background", "gemma-2b"])


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_handle_gives_jax_next_tokens(arch, monkeypatch):
    """fp32 on both sides, so the argmax compares the algorithm and not
    where the two frameworks round bf16."""
    monkeypatch.setattr(jax_serve, "_MODEL_OPTS", JaxOptions(compute_dtype="float32"))
    jhandle, jparams, jdata = jax_serve.make_service(arch, smoke=True)
    handle, _, _ = serve.make_service(
        arch, smoke=True, device="cpu", opts=ModelOptions(compute_dtype="float32")
    )
    params = from_jax(jax.tree_util.tree_map(np.asarray, jparams))
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
    for name in ("gemma-2b", "qwen3-8b"):
        assert serve.stable_seed(name) == jax_serve.stable_seed(name)


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
