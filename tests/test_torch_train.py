"""Port training path vs the JAX package on the gemma-2b and qwen3-8b
smoke configs, fp32 compute: ``Model.loss`` and its gradients against
``jax.value_and_grad`` (remat on and off, a chunked loss head and a length
the chunk does not divide; also for the MoE smoke configs, whose loss
carries ``aux_coeff`` times the layers' mean load-balance loss), ``make_train_step`` over two steps with one
and two microbatches, twins of tests/test_train.py's ``TestTrainStep``
and ``TestData``, the runtime tables, and a training session whose first
iteration reports JAX's step-1 loss (the profile took no hidden step)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import TRAIN_4K as JAX_TRAIN_4K  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.data.pipeline import SyntheticLM as JaxSyntheticLM  # noqa: E402
from repro.data.pipeline import make_batch_for as jax_make_batch_for  # noqa: E402
from repro.models import ModelOptions as JaxModelOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.layers import softmax_cross_entropy as jax_ce  # noqa: E402
from repro.train import runtime as jax_runtime  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.train_step import TrainRunConfig as JaxTrainRunConfig  # noqa: E402
from repro.train.train_step import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import SHAPES, TRAIN_4K, get_config  # noqa: E402
from repro_torch.core import (  # noqa: E402
    GB,
    SalusExecutor,
    VirtualDevice,
    get_policy,
    profile_model,
)
from repro_torch.data.pipeline import SyntheticLM, make_batch_for  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.models.layers import softmax_cross_entropy  # noqa: E402
from repro_torch.train import runtime  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.train_step import (  # noqa: E402
    TrainRunConfig,
    _split_microbatches,
    make_eval_step,
    make_grad_fn,
    make_train_step,
    stack_grads,
    value_and_grad,
)
from repro_torch.weights import from_jax  # noqa: E402

ARCHS = ["gemma-2b", "qwen3-8b"]
MOE_ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
CPU = torch.device("cpu")
# AdamW at its warmup lr (adamw_config_for's lr 3e-4 over 200 warmup
# steps): Adam's first steps move each element by about lr * sign(g), so a
# gradient within rounding of 0 may flip an element by 2 lr; at the warmup
# lr that stays inside the JAX test's atol (tests/test_train.py:73)
WARMUP = dict(lr=3e-4, warmup_steps=200, total_steps=50_000)


def _models(arch, **opts):
    jm = jax_build_model(jax_get_config(arch).smoke(),
                         JaxModelOptions(compute_dtype="float32", **opts))
    m = build_model(get_config(arch).smoke(), ModelOptions(compute_dtype="float32", **opts))
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, m, jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)


def _batch(vocab, b, s, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (b, s)).astype(np.int32)
    labs = rng.integers(0, vocab, (b, s)).astype(np.int32)
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labs)})


def _leaf(tree, path):
    for k in path:
        tree = tree[k.key]
    return tree


def _assert_tree_close(ours, theirs, rtol, atol):
    leaves = jax.tree_util.tree_leaves_with_path(theirs)
    assert len(leaves) == len(jax.tree_util.tree_leaves(ours))
    for path, a in leaves:
        np.testing.assert_allclose(_leaf(ours, path).float().numpy(), np.asarray(a, np.float32),
                                   rtol=rtol, atol=atol, err_msg=jax.tree_util.keystr(path))


# seq 16: four chunks of 8; 8 does not divide 12. MoE: remat on and off
@pytest.mark.parametrize("arch,remat,seq", [
    (a, r, s) for a in ARCHS for r in (True, False) for s in (16, 12)
] + [(a, r, 16) for a in MOE_ARCHS for r in (True, False)])
def test_loss_and_grads_match_jax(arch, remat, seq):
    moe = dict(moe_group=8) if arch in MOE_ARCHS else {}  # several groups
    jm, m, jp, p = _models(arch, loss_chunk=8, remat=remat, **moe)
    jb, tb = _batch(get_config(arch).smoke().vocab_size, 2, seq, seed=seq)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, jb)
    loss, grads = value_and_grad(m, p, tb)
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    _assert_tree_close(stack_grads(grads), jgrads, rtol=1e-4, atol=1e-6)
    # through the stacked leaves themselves, as a user would differentiate
    leaves, spec = torch.utils._pytree.tree_flatten(p)
    inputs = [t.clone().requires_grad_() for t in leaves]
    direct = m.loss(torch.utils._pytree.tree_unflatten(inputs, spec), tb)
    dgrads = torch.autograd.grad(direct, inputs)
    assert float(direct.detach()) == float(loss)
    for a, b in zip(dgrads, torch.utils._pytree.tree_leaves(stack_grads(grads))):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_loss_is_nll_plus_aux(arch):
    """The loss is the head's NLL plus ``aux_coeff`` times the aux loss
    ``apply`` reports (JAX's loss, held above): a larger coefficient
    moves it by the same aux."""
    _, tb = _batch(256, 2, 16, seed=7)
    cfg = get_config(arch).smoke()
    params = build_model(cfg).init(torch.Generator().manual_seed(7))
    losses = {}
    with torch.no_grad():
        for coeff in (0.01, 1.0):
            m = build_model(cfg, ModelOptions(compute_dtype="float32", loss_chunk=8, moe_group=8,
                                              aux_coeff=coeff))
            losses[coeff] = float(m.loss(params, tb))
        aux = float(m.apply(params, tb)[1])
    assert aux > 0
    assert losses[1.0] - losses[0.01] == pytest.approx(0.99 * aux, rel=1e-4)


def test_loss_without_grad_and_eval_step():
    jm, m, jp, p = _models("gemma-2b", loss_chunk=8)
    jb, tb = _batch(256, 2, 16, seed=4)
    with torch.no_grad():
        assert float(m.loss(p, tb)) == pytest.approx(float(jm.loss(jp, jb)), rel=1e-5)
    assert float(make_eval_step(m)(p, tb)) == pytest.approx(float(jm.loss(jp, jb)), rel=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_cross_entropy_matches_jax(masked):
    rng = np.random.default_rng(9)
    logits = rng.standard_normal((3, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, (3, 5)).astype(np.int32)
    mask = (rng.random((3, 5)) > 0.4).astype(np.float32) if masked else None
    ours = softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                 None if mask is None else torch.from_numpy(mask))
    theirs = jax_ce(jnp.asarray(logits), jnp.asarray(labels),
                    None if mask is None else jnp.asarray(mask))
    assert float(ours) == pytest.approx(float(theirs), rel=1e-6)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_over_two_steps(arch, n_micro):
    jm, m, jp, p = _models(arch, loss_chunk=8)
    jopt, opt = JaxAdamW(JaxAdamWConfig(**WARMUP)), AdamW(AdamWConfig(**WARMUP))
    js, s = jopt.init(jp), opt.init(p)
    jstep = jax.jit(jax_make_train_step(jm, jopt, JaxTrainRunConfig(num_microbatches=n_micro)))
    step = make_train_step(m, opt, TrainRunConfig(num_microbatches=n_micro))
    for i in range(2):
        jb, tb = _batch(256, 4, 16, seed=10 + i)
        jp, js, jmet = jstep(jp, js, jb)
        p2, s2, met = step(p, s, tb)
        assert p2 is p and s2 is s  # updated in place
        assert float(met["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert float(met["lr"]) == float(jmet["lr"])
        assert float(met["grad_norm"]) == pytest.approx(float(jmet["grad_norm"]), rel=1e-5)
        assert int(met["step"]) == int(jmet["step"]) == int(s["step"]) == i + 1
        _assert_tree_close(p, jp, rtol=1e-4, atol=1e-5)
        _assert_tree_close(s["m"], js["m"], rtol=1e-4, atol=1e-7)
        _assert_tree_close(s["v"], js["v"], rtol=1e-4, atol=1e-9)


def test_microbatches_are_strided():
    batch = {"tokens": torch.arange(12).reshape(6, 2)}
    mbs = _split_microbatches(batch, 3)["tokens"]
    assert mbs.shape == (3, 2, 2)
    assert mbs[1, :, 0].tolist() == [2, 8]  # rows 1 and 4
    with pytest.raises(ValueError):
        _split_microbatches(batch, 4)
    with pytest.raises(ValueError):
        make_grad_fn(None, TrainRunConfig(grad_accum_shardings=object()))


class TestTrainStepTwins:
    """tests/test_train.py::TestTrainStep on the port."""

    def test_microbatch_equivalence(self):
        _, m, _, params = _models("gemma-2b", loss_chunk=8)
        opt = AdamW(AdamWConfig(grad_clip=0.0))
        _, batch = _batch(256, 4, 16, seed=1)
        p1 = jax.tree_util.tree_map(torch.clone, params)
        p4 = jax.tree_util.tree_map(torch.clone, params)
        _, _, m1 = make_train_step(m, opt, TrainRunConfig(num_microbatches=1))(p1, opt.init(p1), batch)
        _, _, m4 = make_train_step(m, opt, TrainRunConfig(num_microbatches=4))(p4, opt.init(p4), batch)
        assert float(m1["loss"]) == pytest.approx(float(m4["loss"]), rel=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(p1), jax.tree_util.tree_leaves(p4)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)

    def test_loss_decreases_on_learnable_data(self):
        _, m, _, params = _models("qwen3-8b", loss_chunk=8)
        opt = AdamW(AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100))
        state = opt.init(params)
        pipe = SyntheticLM(256, 32, 8, seed=1)
        step = make_train_step(m, opt)
        losses = []
        for i in range(25):
            batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
            params, state, metrics = step(params, state, batch)
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0] - 0.5

    def test_grad_transform_hook_applied(self):
        _, m, _, params = _models("gemma-2b", loss_chunk=8)
        opt = AdamW(AdamWConfig(grad_clip=0.0))
        _, batch = _batch(256, 2, 16, seed=2)
        zero = lambda g: jax.tree_util.tree_map(torch.zeros_like, g)
        step = make_train_step(m, opt, TrainRunConfig(grad_transform=zero))
        _, _, metrics = step(params, opt.init(params), batch)
        assert float(metrics["grad_norm"]) == 0.0


@pytest.mark.parametrize("seed,step", [(0, 0), (7, 3), (11, 42)])
def test_synthetic_lm_matches_jax_byte_for_byte(seed, step):
    ours = SyntheticLM(1000, 24, 6, seed=seed).batch(step)
    theirs = JaxSyntheticLM(1000, 24, 6, seed=seed).batch(step)
    assert set(ours) == set(theirs) == {"tokens", "labels"}
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype
        assert ours[k].tobytes() == theirs[k].tobytes()
    np.testing.assert_array_equal(ours["labels"][:, :-1], ours["tokens"][:, 1:])
    for a, b in zip(SyntheticLM(1000, 24, 6, seed=seed).host_slice(step, 1, 3).values(),
                    JaxSyntheticLM(1000, 24, 6, seed=seed).host_slice(step, 1, 3).values()):
        assert a.tobytes() == b.tobytes()


def test_make_batch_for_matches_jax():
    for arch in ARCHS:
        ours = make_batch_for(get_config(arch).smoke(), TRAIN_4K.__class__("t", "train", 16, 2), 3, 5)
        theirs = jax_make_batch_for(jax_get_config(arch).smoke(),
                                    JAX_TRAIN_4K.__class__("t", "train", 16, 2), 3, 5)
        assert {k: v.tobytes() for k, v in ours.items()} == {k: v.tobytes() for k, v in theirs.items()}


def test_runtime_tables_match_jax():
    assert runtime._TRAIN_TABLE == jax_runtime._TRAIN_TABLE
    assert {k: (v.kind, v.seq_len, v.global_batch) for k, v in SHAPES.items()} == {
        k: (v.kind, v.seq_len, v.global_batch)
        for k, v in __import__("repro.configs", fromlist=["SHAPES"]).SHAPES.items()
    }
    for arch in ARCHS + ["rwkv6-7b"] + MOE_ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_config(arch).smoke(), jax_get_config(arch).smoke())):
            run, jrun = runtime.train_run_config_for(cfg, TRAIN_4K), jax_runtime.train_run_config_for(jcfg, JAX_TRAIN_4K)
            assert (run.num_microbatches, run.accum_dtype) == (jrun.num_microbatches, jrun.accum_dtype)
            assert runtime.adamw_config_for(cfg).__dict__ == jax_runtime.adamw_config_for(jcfg).__dict__
            opts = runtime.model_options_for(cfg, TRAIN_4K)
            jopts = jax_runtime.model_options_for(jcfg, JAX_TRAIN_4K)
            for field in ("remat", "wkv_chunk", "moe_group", "loss_chunk", "aux_coeff",
                          "compute_dtype", "param_dtype"):
                assert getattr(opts, field) == getattr(jopts, field), field
            assert opts.kernel_mode == "kernel"
    gemma = runtime.train_run_config_for(get_config("gemma-2b"), TRAIN_4K)
    assert gemma.num_microbatches == 4 and gemma.accum_dtype == "float32"


def _train_session_run(policy, capacity, paging, sessions):
    from repro_torch.core import MemoryConfig

    ex = SalusExecutor(capacity, get_policy(policy), memory=MemoryConfig(paging=paging),
                       accounting="nominal", device=CPU)
    vdev = VirtualDevice(ex)
    out = [vdev.create_session(*args, **kw) for args, kw in sessions]
    return vdev.run(), out


def test_training_session_first_iteration_is_jax_step_one():
    """A training session whose profile comes from ``profile_model``: its
    first iteration reports JAX's step-1 loss and its params after three
    iterations are JAX's after three steps. Profiling wrote to nothing."""
    jm, m, jp, params = _models("gemma-2b", loss_chunk=8)
    jopt, opt = JaxAdamW(JaxAdamWConfig(**WARMUP)), AdamW(AdamWConfig(**WARMUP))
    js, state = jopt.init(jp), opt.init(params)
    jstep = jax.jit(jax_make_train_step(jm, jopt))
    pipe = SyntheticLM(256, 16, 4, seed=2)
    step = make_train_step(m, opt)

    def session_step(st, batch):
        p, o, metrics = step(*st, batch)
        return (p, o), metrics

    data_fn = lambda i: {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
    snapshot = [t.clone() for t in jax.tree_util.tree_leaves((params, state))]
    prof = profile_model(m, params, data_fn(0), opt)
    assert all(torch.equal(a, b) for a, b in zip(snapshot, jax.tree_util.tree_leaves((params, state))))
    assert int(state["step"]) == 0
    assert prof.persistent == 3 * sum(t.numel() * 4 for t in jax.tree_util.tree_leaves(params)) + 8
    assert prof.ephemeral >= sum(t.numel() * 4 for t in jax.tree_util.tree_leaves(params))
    rep, (sess,) = _train_session_run("fifo", GB, False, [
        (("train:gemma-2b-smoke", session_step, (params, state), data_fn, 3), dict(profile=prof)),
    ])
    assert not rep.failures and sess.finished
    for i in range(3):
        jp, js, jmet = jstep(jp, js, {k: jnp.asarray(v) for k, v in pipe.batch(i).items()})
        assert float(sess.metrics_log[i]["loss"]) == pytest.approx(float(jmet["loss"]), rel=1e-5)
        assert int(sess.metrics_log[i]["step"]) == i + 1
    _assert_tree_close(sess.state[0], jp, rtol=1e-4, atol=1e-5)


def test_profile_model_loss_only_and_cpu_lower_bound():
    _, m, _, params = _models("qwen3-8b", loss_chunk=8)
    _, batch = _batch(256, 2, 16, seed=3)
    bytes_p = sum(t.numel() * 4 for t in jax.tree_util.tree_leaves(params))
    prof = profile_model(m, params, batch)
    assert prof.persistent == bytes_p and prof.ephemeral >= 1
    opt = AdamW(AdamWConfig(state_dtype="bfloat16"))
    prof = profile_model(m, params, batch, opt, TrainRunConfig(num_microbatches=2))
    assert prof.persistent == bytes_p + bytes_p + 8  # m and v in bf16
    # the gradients and the 0-d loss, plus the update's temporaries
    assert prof.ephemeral == bytes_p + 4 + opt.update_temp_bytes(params)
