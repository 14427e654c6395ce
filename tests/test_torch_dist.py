"""The port's dist layer against the JAX package's: ``param_spec`` on every
param and AdamW-state leaf of the ten archs' smoke trees on four meshes
(16x16, 4x2, 2x16x16 pod/data/model, 1x1), ZeRO-3 on and off; the cache
and batch layouts the same way; twins of tests/test_dist_rules.py's
sharding tests, of tests/test_sharding.py's rule coverage and its 8-device
train step, and of tests/test_elastic.py.

The multi-rank tests run ranks of a gloo group on localhost
(``tests/torch_ranks.py``): the sharded step on a (2, 2) mesh against the
single-process step, and a checkpoint saved there restored by a fresh
launch of 2 ranks onto (1, 2). JAX's twins run 8 devices, (4, 2) -> (2,
2); 8 and 4 rank processes cost ~100 s of CPU a run, so the ranks here
are half as many (the same axes, shardings and shrink)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch_ranks  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShapeConfig  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.models import ModelOptions as JaxModelOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.dist import sharding as sh  # noqa: E402
from repro_torch.dist.api import constrain, constrain_weight, current, placements, use_sharding  # noqa: E402
from repro_torch.dist.elastic import shrink_mesh  # noqa: E402
from repro_torch.dist.fault import FailureInjector, InjectedFailure  # noqa: E402
from repro_torch.launch.mesh import make_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.train_step import TrainRunConfig, make_train_step  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

CPU = torch.device("cpu")
AXES = ("data", "model")


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"16x16": ((16, 16), AXES), "4x2": ((4, 2), AXES),
          "pod2x16x16": ((2, 16, 16), ("pod",) + AXES), "1x1": ((1, 1), AXES)}


def _meshes(name):
    shape, axes = MESHES[name]
    return FakeMesh(shape, axes), AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """``{key: shape}`` of the JAX and the port smoke params and AdamW
    state, by "/"-joined path."""
    cfg = jax_get_config(arch).smoke()
    jp = jax.eval_shape(jax_build_model(cfg, JaxModelOptions()).init, jax.random.PRNGKey(0))
    jtree = {"params": jp, "opt": jax.eval_shape(JaxAdamW().init, jp)}
    p = build_model(get_config(arch).smoke()).init(torch.Generator().manual_seed(0))
    tree = {"params": p, "opt": AdamW().init(p)}
    keys = lambda flat: {sh._path_str(path): leaf for path, leaf in flat}
    return (keys(jax.tree_util.tree_flatten_with_path(jtree)[0]),
            keys(pytree.tree_flatten_with_path(tree)[0]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_spec_equals_jax_on_every_leaf(arch, mesh):
    fake, _ = _meshes(mesh)
    jleaves, leaves = _trees(arch)
    assert set(jleaves) == set(leaves)
    cfg, jcfg = get_config(arch).smoke(), jax_get_config(arch).smoke()
    for zero3 in (False, True):
        for key, leaf in leaves.items():
            assert tuple(leaf.shape) == tuple(jleaves[key].shape), key
            path = tuple(key.split("/"))
            theirs = jsh.param_spec(path, jleaves[key].shape, jcfg, fake, zero3=zero3)
            ours = sh.param_spec(path, tuple(leaf.shape), cfg, fake, zero3=zero3)
            assert ours == tuple(theirs), (key, zero3)


def _cache_trees():
    """The smoke caches of gemma-2b (bf16 and int8), rwkv6-7b and
    hymba-1.5b, stacked and per layer, plus every rule's leaf by hand, as
    numpy zeros (both packages read only shapes)."""
    out = []
    for arch, opts in (("gemma-2b", {}), ("gemma-2b", {"kv_quantized": True}),
                       ("rwkv6-7b", {}), ("hymba-1.5b", {})):
        m = build_model(get_config(arch).smoke(), ModelOptions(**opts))
        for stacked in (True, False):
            cache = m.init_cache(16, 32, stacked=stacked, device=CPU)
            out.append(pytree.tree_map(lambda t: np.zeros(t.shape, np.float32), cache))
    shapes = {"k": (2, 16, 32, 4, 16), "k_scale": (2, 16, 32, 4), "conv": (2, 16, 3, 256),
              "h": (2, 16, 256, 8), "wkv": (2, 16, 4, 16, 16), "tmix_shift": (2, 16, 1, 64),
              "other": (2, 16)}
    out.append({k: np.zeros(v, np.float32) for k, v in shapes.items()})
    out.append({k: np.zeros(v[1:], np.float32) for k, v in shapes.items()})
    return out


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_cache_and_batch_layouts_equal_jax(mesh):
    fake, abstract = _meshes(mesh)
    shape = ShapeConfig("d", "decode", 32, 16)
    jshape = JaxShapeConfig("d", "decode", 32, 16)
    cfg, jcfg = get_config("qwen3-8b").smoke(), jax_get_config("qwen3-8b").smoke()
    layout = lambda x: isinstance(x, tuple) and x[0] is fake
    for cache in _cache_trees():
        ours = pytree.tree_flatten_with_path(sh.cache_shardings(cache, cfg, shape, fake),
                                             is_leaf=layout)[0]
        theirs = jax.tree_util.tree_flatten_with_path(
            jsh.cache_shardings(cache, jcfg, jshape, abstract))[0]
        assert {sh._path_str(p): pl for p, (_, pl) in ours} == {
            sh._path_str(p): placements(tuple(s.spec), fake) for p, s in theirs}
    for arch in sorted(ARCHS):
        cfg, jcfg = get_config(arch).smoke(), jax_get_config(arch).smoke()
        for kind in ("train", "prefill", "decode"):
            for b in (16, 4, 1):
                ours = sh.batch_shardings(cfg, ShapeConfig("b", kind, 16, b), fake)
                theirs = jsh.batch_shardings(jcfg, JaxShapeConfig("b", kind, 16, b), abstract)
                assert list(ours) == list(theirs)
                assert {k: pl for k, (_, pl) in ours.items()} == {
                    k: placements(tuple(s.spec), fake) for k, s in theirs.items()}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_rules_cover_every_leaf(name):
    """tests/test_sharding.py's twin: every leaf of every arch has a spec
    of its rank on the 16x16 axes."""
    fake = FakeMesh((16, 16), AXES)
    params = build_model(get_config(name).smoke()).init(torch.Generator().manual_seed(0))
    for path, leaf in pytree.tree_flatten_with_path(params)[0]:
        spec = sh.param_spec(path, leaf.shape, get_config(name), fake)
        assert isinstance(spec, tuple) and len(spec) == leaf.dim()


def test_placements_put_a_shard_on_each_mesh_axis_of_a_dim():
    mesh = FakeMesh((2, 16, 16), ("pod",) + AXES)
    assert placements((("pod", "data"), None, "model"), mesh) == [Shard(0), Shard(0), Shard(2)]
    assert placements((None, None), mesh) == [Replicate()] * 3


# --- twins of tests/test_dist_rules.py ----------------------------------------

Mesh16 = FakeMesh((16, 16), AXES)
ARCH = get_config("qwen3-8b")


def test_param_spec_replicates_non_dividing_dims():
    spec = sh.param_spec(("m", "layers", "moe", "w_gate"), (48, 4, 64, 128), ARCH, Mesh16)
    assert spec == (None, None, None, None)
    spec = sh.param_spec(("layers", "attn", "wq"), (48, 64, 64), ARCH, Mesh16)
    assert spec == (None, None, "model")
    spec = sh.param_spec(("layers", "attn", "wq"), (48, 64, 40), ARCH, Mesh16)
    assert spec == (None, None, None)


def test_param_spec_unmatched_path_is_replicated():
    assert sh.param_spec(("final_norm", "scale"), (64,), ARCH, Mesh16) == (None,)
    assert sh.param_spec(("step",), (), ARCH, Mesh16) == ()


def test_param_spec_zero3_adds_data_axis_but_skips_layer_dim():
    spec = sh.param_spec(("layers", "attn", "wq"), (48, 64, 64), ARCH, Mesh16, zero3=True)
    assert spec == (None, "data", "model")


@pytest.fixture
def one_rank():
    """A one-rank gloo group over a HashStore (no network), its (1, 1) mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), AXES, "cpu")
    finally:
        dist.destroy_process_group()


def test_use_sharding_noop_outside_mesh_context(one_rank):
    assert current() is None
    x = torch.ones(4, 8, 16)
    assert constrain(x, ("data", None, None)) is x
    assert constrain_weight(x, (None, None, "model")) is x
    ctx = sh.make_context(one_rank, ARCH.smoke())
    with use_sharding(ctx):
        assert current() is ctx
        assert constrain(x, ("data", None)) is x
        assert constrain(x, ("data", None, None)) is x  # a plain tensor: no layout
    assert current() is None


def test_batch_shardings_replicate_when_batch_too_small(one_rank):
    b_sh = sh.batch_shardings(ARCH.smoke(), ShapeConfig("t", "train", 16, 1), one_rank)
    assert set(b_sh) == {"tokens", "labels"}
    for mesh, pl in b_sh.values():
        assert mesh is one_rank and pl == [Replicate(), Replicate()]


def test_cache_shardings_cover_stacked_and_per_layer_layouts(one_rank):
    shape = ShapeConfig("d", "decode", 32, 4)
    stacked = {"k": torch.zeros(2, 4, 32, 2, 16), "v": torch.zeros(2, 4, 32, 2, 16)}
    per_layer = {"k": torch.zeros(4, 32, 2, 16)}
    for cache in (stacked, per_layer):
        assert set(sh.cache_shardings(cache, ARCH.smoke(), shape, one_rank)) == set(cache)
    assert sh.replicated(one_rank) == (one_rank, [Replicate(), Replicate()])


def test_injector_each_step_fires_independently():
    inj = FailureInjector([2, 5])
    inj.maybe_fail(0)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(2)
    inj.maybe_fail(2)
    with pytest.raises(InjectedFailure):
        inj.maybe_fail(5)


def test_shrink_mesh_math_and_its_error(one_rank):
    """(c): the leading axis absorbs the loss; losing every group raises
    before any mesh is made; a mesh needs the group's ranks exactly."""
    m = shrink_mesh((1, 1), AXES, lost=0, device_type="cpu")
    assert dict(zip(m.mesh_dim_names, m.shape)) == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="shrink"):
        shrink_mesh((1, 1), AXES, lost=1, device_type="cpu")
    with pytest.raises(ValueError, match="shrink"):
        shrink_mesh((4, 2), AXES, lost=7, device_type="cpu")
    with pytest.raises(ValueError, match="ranks"):
        shrink_mesh((4, 2), AXES, lost=6, device_type="cpu")  # (1, 2): 2 ranks, the group has 1
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh(device_type="cpu")


def test_train_step_refuses_malformed_accumulator_layouts(one_rank):
    from repro_torch.train.train_step import make_grad_fn

    with pytest.raises(ValueError, match="data axes"):
        make_grad_fn(None, TrainRunConfig(grad_accum_shardings={"w": (one_rank, [Shard(0), Replicate()])}))


# --- several ranks ----------------------------------------------------------

STEP_ARCHS = ["qwen3-8b", "mixtral-8x22b", "rwkv6-7b", "hymba-1.5b"]
# (arch, zero3, accumulator layout): the JAX test's four, and qwen3-8b under
# ZeRO-3 given JAX's accumulator layout (the model shards), which the port
# accepts and which changes nothing
STEP_RUNS = {a: (a, False, False) for a in STEP_ARCHS} | {"qwen3-8b zero3": ("qwen3-8b", True, True)}
BATCH, SEQ = 4, 16  # two rows a data rank: one a microbatch
LAUNCH_TIMEOUT = 240


def _jax_params(arch):
    jm = jax_build_model(jax_get_config(arch).smoke(), JaxModelOptions(
        **{k: v for k, v in torch_ranks.MODEL_OPTS.items()}))
    return jm, jm.init(jax.random.PRNGKey(0))


def _batch(arch, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, get_config(arch).smoke().vocab_size, (BATCH, SEQ)).astype(np.int32)
    labs = rng.integers(0, get_config(arch).smoke().vocab_size, (BATCH, SEQ)).astype(np.int32)
    return {"tokens": toks, "labels": labs}


@pytest.fixture(scope="module")
def step_launch(tmp_path_factory):
    """One launch of 4 ranks for every run; its inputs and rank 0's result."""
    workdir = tmp_path_factory.mktemp("ranks")
    runs = {}
    for name, (arch, zero3, local_accum) in STEP_RUNS.items():
        _, jp = _jax_params(arch)
        runs[name] = {"arch": arch, "zero3": zero3, "local_accum": local_accum,
                      "params": from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU),
                      "batch": {k: torch.from_numpy(v) for k, v in _batch(arch, 3).items()}}
    torch.save({"runs": runs, "save": "qwen3-8b"}, workdir / "inputs.pt")
    return workdir, runs, torch_ranks.launch("step", 4, workdir, LAUNCH_TIMEOUT)


def _close(a, b, rtol, atol, what):
    for (path, x), y in zip(pytree.tree_flatten_with_path(a)[0], pytree.tree_leaves(b)):
        np.testing.assert_allclose(x.float().numpy(), y.float().numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{what} {pytree.keystr(path)}")


@pytest.mark.parametrize("name", list(STEP_RUNS))
def test_sharded_train_step_on_a_2x2_mesh_matches_one_process(step_launch, name):
    """(a) tests/test_sharding.py's sharded step on the port: loss, grad
    norm and the updated params and state equal the single-process step's
    within tests/test_torch_train.py's tolerance; the single-process loss
    equals JAX's. Each rank takes its 2 rows as 2 microbatches, so the
    single-process step takes the same 4 microbatches of one row: the MoE
    aux loss depends on the rows a call sees (a data-parallel step takes
    it over each rank's microbatch)."""
    _, runs, out = step_launch
    run, res = runs[name], out[name]
    cfg = get_config(run["arch"]).smoke()
    model = build_model(cfg, ModelOptions(**torch_ranks.MODEL_OPTS))
    opt = AdamW(AdamWConfig(**torch_ranks.WARMUP))
    params = pytree.tree_map(torch.clone, run["params"])
    state = opt.init(params)
    step = make_train_step(model, opt, TrainRunConfig(num_microbatches=BATCH))
    params, state, metrics = step(params, state, run["batch"])
    jm, jp = _jax_params(run["arch"])
    jloss = jax.jit(jm.loss)
    rows = [float(jloss(jp, {k: jnp.asarray(v[i:i + 1].numpy()) for k, v in run["batch"].items()}))
            for i in range(BATCH)]
    assert float(metrics["loss"]) == pytest.approx(sum(rows) / BATCH, rel=1e-5)
    assert res["loss"] == pytest.approx(float(metrics["loss"]), rel=1e-5)
    assert res["grad_norm"] == pytest.approx(float(metrics["grad_norm"]), rel=1e-5)
    _close(res["tree"]["params"], params, 1e-4, 1e-5, "params")
    _close(res["tree"]["opt"]["m"], state["m"], 1e-4, 1e-7, "m")
    _close(res["tree"]["opt"]["v"], state["v"], 1e-4, 1e-9, "v")
    assert int(res["tree"]["opt"]["step"]) == 1
    assert out["constrained"] == [Shard(0), Shard(2)]


@pytest.fixture(scope="module")
def restore_launch(step_launch):
    """The fresh launch of 2 ranks after the step launch; rank 0's result."""
    return torch_ranks.launch("restore", 2, step_launch[0], LAUNCH_TIMEOUT)


def test_shrink_restore(step_launch, restore_launch):
    """(b) tests/test_elastic.py's twin: the checkpoint saved on (2, 2)
    (after qwen3-8b's step) restored by a fresh launch of 2 ranks onto
    (1, 2): identical values, every leaf on the 2 ranks."""
    _, _, out = step_launch
    res = restore_launch
    assert res["step"] == 1 and res["mesh"] == {"data": 1, "model": 2} and res["ranks"] == [2]
    saved = out["qwen3-8b"]["tree"]
    assert len(pytree.tree_leaves(res["tree"])) == len(pytree.tree_leaves(saved))
    for (path, a), b in zip(pytree.tree_flatten_with_path(res["tree"])[0],
                            pytree.tree_leaves(saved)):
        assert a.dtype == b.dtype and torch.equal(a, b), pytree.keystr(path)


def test_async_saves_resume_on_every_rank(restore_launch):
    """Saved asynchronously after every step on 2 ranks, rank 0's writes
    slowed, killed at RESUME_FAIL_AT and resumed in the same launch: every
    rank waits for rank 0's writes and restores the same step, so losses,
    params and state equal the uninterrupted run's bit for bit; keep=2
    leaves two step directories; a failed write on rank 0 raises on both
    ranks' ``wait``."""
    res = restore_launch["resume"]
    assert res["restarts"] == 1
    assert [r["restored"] for r in res["per_rank"]] == [torch_ranks.RESUME_FAIL_AT] * 2
    assert res["losses_b"] == res["losses_a"]
    for (path, a), b in zip(pytree.tree_flatten_with_path(res["tree_b"])[0],
                            pytree.tree_leaves(res["tree_a"])):
        assert a.dtype == b.dtype and torch.equal(a, b), pytree.keystr(path)
    steps = torch_ranks.RESUME_STEPS
    assert res["left"] == [f"step_{s:08d}" for s in (steps - 1, steps)]
    for r in res["per_rank"]:
        assert r["raised"] is not None and "disk full" in r["raised"], res["per_rank"]
