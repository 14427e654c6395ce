"""The port's checkpoints and int8 error-feedback gradient compression
against the JAX package: twins of tests/test_ckpt.py, checkpoints crossing
between the two managers in both directions (bf16, fp32 and int32 leaves,
bit for bit, equal manifests), the next AdamW step from a JAX-written
state, an async save immune to the optimizer's in-place updates, and the
compression payload against JAX's bit for bit (twins of
tests/test_train.py::TestGradCompression and of tests/test_property.py's
two compression properties)."""
import json
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import hypothesis.strategies as st  # noqa: E402
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.distributed as dist  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from torch.distributed.tensor import DTensor, Replicate  # noqa: E402
from torch.utils import _pytree as pytree  # noqa: E402

from repro.ckpt.checkpoint import CheckpointManager as JaxCheckpointManager  # noqa: E402
from repro.train.grad_compress import ErrorFeedbackCompressor as JaxEF  # noqa: E402
from repro.train.grad_compress import compress as jax_compress  # noqa: E402
from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.train.grad_compress import (  # noqa: E402
    ErrorFeedbackCompressor,
    compress,
    decompress,
    wire_bytes,
)
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.train_step import value_and_grad, stack_grads  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

CPU = torch.device("cpu")


def make_tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "layers": {"w": torch.randn(4, 8, generator=g), "b": torch.zeros(8)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


def _leaves_equal(a, b):
    la, lb = pytree.tree_leaves(a), pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# --- twins of tests/test_ckpt.py ---------------------------------------------


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = make_tree()
    mgr.save(3, tree, meta={"loss": 1.5})
    step, restored, meta = mgr.restore_tree(tree)
    assert step == 3
    assert meta["loss"] == 1.5
    _leaves_equal(tree, restored)


def test_async_save_and_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = make_tree()
    for s in range(3):
        mgr.save(s, tree)
    mgr.wait()
    assert mgr.all_steps() == [0, 1, 2]


def test_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    tree = make_tree()
    for s in range(5):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]


def test_atomicity_tmp_ignored(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = make_tree()
    mgr.save(1, tree)
    # a crash mid-write: a stale .tmp dir and garbage
    crash = Path(tmp_path) / "step_00000002.tmp"
    crash.mkdir()
    (crash / "arr_00000.npy").write_bytes(b"garbage")
    assert mgr.latest_step() == 1
    step, _, _ = mgr.restore_tree(tree)
    assert step == 1


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=False)
    mgr.save(1, make_tree())
    bad = make_tree()
    bad["layers"]["w"] = torch.zeros(2, 2)
    with pytest.raises(ValueError):
        mgr.restore_tree(bad)
    bad = make_tree()
    bad["layers"]["w"] = torch.zeros(4, 8, dtype=torch.bfloat16)  # floats are never cast
    with pytest.raises(ValueError, match="dtype"):
        mgr.restore_tree(bad)


@pytest.fixture
def one_rank():
    """A one-rank gloo group over a HashStore (no network)."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield make_mesh((1, 1), ("data", "model"), "cpu")
    finally:
        dist.destroy_process_group()


def test_restore_with_shardings_single_device(tmp_path, one_rank):
    mgr = CheckpointManager(tmp_path, async_save=False)
    tree = make_tree()
    mgr.save(1, tree)
    layouts = pytree.tree_map(lambda _: (one_rank, [Replicate(), Replicate()]), tree)
    _, restored, _ = mgr.restore_tree(tree, shardings=layouts)
    w = restored["layers"]["w"]
    assert isinstance(w, DTensor) and w.device_mesh is one_rank
    assert torch.equal(w.to_local(), tree["layers"]["w"])
    # a DTensor leaf saves gathered, and restores as it was
    mgr.save(2, restored)
    _leaves_equal(mgr.restore_tree(tree, step=2)[1], tree)


# --- checkpoints across the two packages --------------------------------------


def _state_tree(rng):
    """A model-shaped tree of fp32 params and a maker of gradients. Its
    dicts are in sorted key order, the order of the trees JAX returns (the
    port's trees keep their insertion order)."""
    params = {
        "embed": {"table": rng.standard_normal((32, 8)).astype(np.float32)},
        "final_norm": {"scale": np.ones((8,), np.float32)},
        "layers": {"attn": {"wq": rng.standard_normal((3, 8, 8)).astype(np.float32)},
                   "attn_norm": {"scale": (1 + 0.1 * rng.standard_normal((3, 8))).astype(np.float32)}},
    }
    grads = lambda: jax.tree_util.tree_map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape).astype(np.float32)), params)
    return params, grads


ADAMW = dict(lr=1e-2, warmup_steps=2, total_steps=20, state_dtype="bfloat16")


def test_jax_checkpoint_restores_in_the_port_and_steps_like_jax(tmp_path):
    rng = np.random.default_rng(0)
    params_np, grads = _state_tree(rng)
    jopt = JaxAdamW(JaxAdamWConfig(**ADAMW))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    jparams, jstate, _ = jopt.update(grads(), jopt.init(jparams), jparams)
    assert jstate["m"]["embed"]["table"].dtype == jnp.bfloat16 and jstate["step"].dtype == jnp.int32
    jmgr = JaxCheckpointManager(tmp_path, async_save=False)
    jmgr.save(1, {"params": jparams, "opt": jstate})

    opt = AdamW(AdamWConfig(**ADAMW))
    meta = lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta")
    template_params = pytree.tree_map(meta, from_jax(params_np, CPU))
    template = {"params": template_params, "opt": opt.init(template_params)}
    step, tree, _ = CheckpointManager(tmp_path, async_save=False).restore_tree(template)
    assert step == 1
    # leaf for leaf, bit for bit: bf16 moments, fp32 params; the int32
    # step counter cast to the port's int64
    for (path, a) in jax.tree_util.tree_leaves_with_path({"params": jparams, "opt": jstate}):
        t = tree
        for k in path:
            t = t[k.key]
        ref = from_jax(np.asarray(a), CPU)
        if path[-1].key == "step":
            assert t.dtype == torch.int64 and int(t) == int(a) == 1
            continue
        assert t.dtype == ref.dtype and torch.equal(t, ref), jax.tree_util.keystr(path)

    g = grads()
    jparams, jstate, jm = jopt.update(g, jstate, jparams)
    params, state, m = opt.update(from_jax(jax.tree_util.tree_map(np.asarray, g), CPU),
                                  tree["opt"], tree["params"])
    assert int(m["step"]) == int(jm["step"]) == 2
    assert float(m["lr"]) == float(jm["lr"])
    for (path, a) in jax.tree_util.tree_leaves_with_path({"params": jparams, "m": jstate["m"],
                                                          "v": jstate["v"]}):
        t = {"params": params, "m": state["m"], "v": state["v"]}
        for k in path:
            t = t[k.key]
        tol = (1e-5, 1e-6) if path[0].key == "params" else (2e-2, 2e-2)  # test_torch_optimizer's
        np.testing.assert_allclose(t.float().numpy(), np.asarray(a, np.float32),
                                   rtol=tol[0], atol=tol[1], err_msg=jax.tree_util.keystr(path))


def test_port_checkpoint_restores_in_jax_with_the_same_manifest(tmp_path):
    rng = np.random.default_rng(1)
    tree_np = {
        "z": {"b": rng.standard_normal((3, 5)).astype(np.float32),
              "a": rng.standard_normal((7,)).astype(jnp.bfloat16)},
        "a_b": np.arange(4, dtype=np.int32),
        "a": {"x": rng.standard_normal((2, 2)).astype(jnp.bfloat16)},
        "seq": [np.float32(2.5) * np.ones((2,), np.float32), np.int32(3)],
    }
    port_dir, jax_dir = tmp_path / "port", tmp_path / "jax"
    tree = from_jax({k: v for k, v in tree_np.items() if k != "seq"}, CPU)
    tree["seq"] = [torch.from_numpy(tree_np["seq"][0]), torch.tensor(3, dtype=torch.int32)]
    CheckpointManager(port_dir, async_save=False).save(4, tree, meta={"k": 1})
    JaxCheckpointManager(jax_dir, async_save=False).save(
        4, jax.tree_util.tree_map(jnp.asarray, tree_np), meta={"k": 1})
    port_manifest = json.loads((port_dir / "step_00000004" / "manifest.json").read_text())
    jax_manifest = json.loads((jax_dir / "step_00000004" / "manifest.json").read_text())
    assert port_manifest == jax_manifest
    assert [e["dtype"] for e in port_manifest["leaves"]].count("bfloat16") == 2
    step, ours, meta = JaxCheckpointManager(port_dir, async_save=False).restore()
    _, theirs, _ = JaxCheckpointManager(jax_dir, async_save=False).restore()
    assert step == 4 and meta == {"k": 1} and list(ours) == list(theirs)
    for key in theirs:
        assert ours[key].shape == theirs[key].shape and ours[key].dtype.itemsize == \
            theirs[key].dtype.itemsize, key
        assert ours[key].tobytes() == theirs[key].tobytes(), key


def test_async_save_is_a_snapshot_of_in_place_updates(tmp_path):
    """The writer is held until the tree has been updated in place (as
    AdamW does): the checkpoint holds the values at the save."""
    mgr = CheckpointManager(tmp_path, async_save=True)
    gate = threading.Event()
    write = mgr._write
    mgr._write = lambda *a: (gate.wait(10), write(*a))
    tree = make_tree()
    before = pytree.tree_map(torch.clone, tree)
    mgr.save(1, tree)
    opt = AdamW(AdamWConfig(lr=0.1, warmup_steps=0))
    params = tree["layers"]
    opt.update(pytree.tree_map(torch.ones_like, params), opt.init(params), params)
    assert not torch.equal(tree["layers"]["w"], before["layers"]["w"])
    gate.set()
    mgr.wait()
    _leaves_equal(mgr.restore_tree(tree)[1], before)


def test_writer_error_surfaces_on_the_next_save_and_wait(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    mgr._write = lambda *a: (_ for _ in ()).throw(OSError("disk full"))
    mgr.save(1, make_tree())
    with pytest.raises(RuntimeError, match="writer failed"):
        mgr.wait()
    with pytest.raises(RuntimeError, match="writer failed"):
        mgr.save(2, make_tree())


# --- compression -------------------------------------------------------------


def _same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("shape,block", [((1000,), 256), ((37,), 16), ((65, 3073), 256),
                                         ((4, 4097), 64), ((5,), 256)])
def test_compress_payload_equals_jax_bit_for_bit(shape, block):
    rng = np.random.default_rng(block + shape[0])
    x = (rng.standard_normal(shape) * rng.choice([1e-3, 1.0, 1e3], shape)).astype(np.float32)
    x.reshape(-1)[::7] = 0.0
    x.reshape(-1)[:3] = [2.0, -0.5, 1e-30]  # a block max, a tie, a denormal-scale block
    ours = compress(torch.from_numpy(x), block)
    theirs = jax_compress(jnp.asarray(x), block)
    _same_bits(ours["q"].numpy(), theirs["q"])
    _same_bits(ours["scale"].numpy(), theirs["scale"])
    assert ours["q"].dtype == torch.int8 and ours["scale"].shape == (-(-x.size // block), 1)


def test_error_feedback_apply_equals_jax():
    rng = np.random.default_rng(3)
    grads_np = {"b": {"c": rng.standard_normal((300,)).astype(np.float32)},
                "w": rng.standard_normal((33, 17)).astype(np.float32)}  # JAX's key order
    ours_c, theirs_c = ErrorFeedbackCompressor(block=64), JaxEF(block=64)
    r, jr = ours_c.init(from_jax(grads_np, CPU)), theirs_c.init(grads_np)
    for _ in range(3):
        g = jax.tree_util.tree_map(lambda a: a * rng.uniform(0.5, 2.0), grads_np)
        deq, r = ours_c.apply(from_jax(g, CPU), r)
        jdeq, jr = theirs_c.apply(jax.tree_util.tree_map(jnp.asarray, g), jr)
        for a, b in zip(pytree.tree_leaves(deq) + pytree.tree_leaves(r),
                        jax.tree_util.tree_leaves(jdeq) + jax.tree_util.tree_leaves(jr)):
            _same_bits(a.numpy(), b)
    with pytest.raises(ValueError):
        ours_c.apply(from_jax(grads_np, CPU), {"w": r["w"]})


class TestGradCompression:
    """tests/test_train.py::TestGradCompression on the port."""

    def test_wire_bytes_4x_reduction(self):
        g = {"w": torch.zeros(1024, 1024), "b": torch.zeros(1024)}
        full = wire_bytes(g, compressed=False)
        comp = wire_bytes(g, compressed=True, block=256)
        assert full / comp > 3.0
        assert comp / full == pytest.approx(0.25 + 1 / 256)

    def test_compressed_training_still_learns(self):
        cfg = get_config("gemma-2b").smoke()
        model = build_model(cfg, ModelOptions(loss_chunk=8, compute_dtype="float32"))
        opt = AdamW(AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=100))
        params = model.init(torch.Generator().manual_seed(0))
        opt_state = opt.init(params)
        comp = ErrorFeedbackCompressor(block=64)
        residual = comp.init(params)
        pipe = SyntheticLM(cfg.vocab_size, 32, 8, seed=3)
        losses = []
        for i in range(20):
            batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
            loss, grads = value_and_grad(model, params, batch)
            grads, residual = comp.apply(stack_grads(grads), residual)
            params, opt_state, _ = opt.update(grads, opt_state, params)
            losses.append(float(loss))
        assert losses[-1] < losses[0] - 0.3


@settings(max_examples=100, deadline=None)
@given(
    data=st.lists(st.floats(min_value=-1e3, max_value=1e3, allow_nan=False), min_size=1, max_size=500),
    block=st.sampled_from([16, 64, 256]),
)
def test_int8_compression_roundtrip_bound(data, block):
    """Quantization error per element is bounded by scale/2 = max|x|/254
    (tests/test_property.py's property on the port)."""
    x = torch.tensor(np.array(data, np.float32))
    y = decompress(compress(x, block), x.shape, block)
    xb = x.numpy()
    pad = (-len(xb)) % block
    xb = np.pad(xb, (0, pad)).reshape(-1, block)
    bound = np.abs(xb).max(axis=1) / 127.0 * 0.5 + 1e-6
    err = np.abs(y.numpy() - x.numpy())
    errb = np.pad(err, (0, pad)).reshape(-1, block)
    assert (errb.max(axis=1) <= bound + 1e-5).all()


@settings(max_examples=30, deadline=None)
@given(seed=st.integers(min_value=0, max_value=1000))
def test_error_feedback_accumulated_update_unbiased(seed):
    """The sum of decompressed updates tracks the sum of true grads to
    within one quantization residual."""
    rng = np.random.default_rng(seed)
    comp = ErrorFeedbackCompressor(block=64)
    g_shape = (37,)
    grads = [torch.from_numpy(rng.normal(size=g_shape).astype(np.float32)) for _ in range(10)]
    state = comp.init(grads[0])
    total_true = np.zeros(g_shape, np.float32)
    total_sent = np.zeros(g_shape, np.float32)
    for g in grads:
        sent, state = comp.apply(g, state)
        total_true += g.numpy()
        total_sent += sent.numpy()
    np.testing.assert_allclose(total_sent + state.numpy(), total_true, rtol=1e-4, atol=1e-4)
