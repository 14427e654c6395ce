"""Port AdamW, schedule and clipping vs the JAX package's
``train/optimizer.py``: twins of tests/test_train.py's ``TestAdamW``, and
``AdamW.update`` held against JAX's on the same numpy trees over three
steps, with fp32 and bf16 moments."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.train.optimizer import AdamW as JaxAdamW  # noqa: E402
from repro.train.optimizer import AdamWConfig as JaxAdamWConfig  # noqa: E402
from repro.train.optimizer import clip_by_global_norm as jax_clip  # noqa: E402
from repro.train.optimizer import cosine_lr as jax_cosine_lr  # noqa: E402
from repro_torch.core.profiles import tensor_bytes  # noqa: E402
from repro_torch.train.optimizer import (  # noqa: E402
    AdamW,
    AdamWConfig,
    clip_by_global_norm,
    cosine_lr,
    global_norm,
)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


class TestAdamWTwins:
    """tests/test_train.py::TestAdamW on the port."""

    def test_single_param_matches_manual_math(self):
        cfg = AdamWConfig(lr=0.1, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.0,
                          grad_clip=0.0, warmup_steps=0, total_steps=10**9,
                          min_lr_ratio=1.0)
        opt = AdamW(cfg)
        p = {"w": _t([[1.0, 2.0]])}
        g = {"w": _t([[0.5, -0.25]])}
        state = opt.init(p)
        p2, state2, _ = opt.update(g, state, p)
        m = 0.1 * np.array([[0.5, -0.25]])
        v = 0.01 * np.array([[0.25, 0.0625]])
        mhat, vhat = m / 0.1, v / 0.01
        expect = np.array([[1.0, 2.0]]) - 0.1 * mhat / (np.sqrt(vhat) + 1e-8)
        np.testing.assert_allclose(p2["w"].numpy(), expect, rtol=1e-5)

    def test_weight_decay_only_on_matrices(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0,
                          warmup_steps=0, total_steps=10**9, min_lr_ratio=1.0)
        opt = AdamW(cfg)
        p = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
        g = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
        state = opt.init(p)
        p2, _, _ = opt.update(g, state, p)
        assert float((p2["b"] - 1.0).abs().max()) == 0.0  # vectors undecayed
        assert float(p2["w"].max()) < 1.0  # matrices decayed

    def test_cosine_schedule_shape(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110, min_lr_ratio=0.1)
        lrs = [float(cosine_lr(cfg, torch.tensor(s))) for s in range(0, 120, 5)]
        assert lrs[0] == 0.0
        assert max(lrs) == pytest.approx(1.0, rel=0.01)
        assert lrs[-1] == pytest.approx(0.1, rel=0.05)

    def test_clip_by_global_norm(self):
        tree = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}  # norm 10
        clipped, norm = clip_by_global_norm(tree, 5.0)
        assert float(norm) == pytest.approx(10.0, rel=1e-5)
        assert float(global_norm(clipped)) == pytest.approx(5.0, rel=1e-5)


def test_cosine_lr_matches_jax_bit_for_bit():
    cfg = dict(lr=3e-4, warmup_steps=200, total_steps=50_000, min_lr_ratio=0.1)
    for step in (0, 1, 2, 199, 200, 201, 1234, 49_999, 50_000, 60_000):
        ours = cosine_lr(AdamWConfig(**cfg), torch.tensor(step))
        theirs = jax_cosine_lr(JaxAdamWConfig(**cfg), jnp.asarray(step))
        assert ours.dtype == torch.float32
        assert float(ours) == float(theirs), step


def test_clip_matches_jax():
    rng = np.random.default_rng(3)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((7,)).astype(np.float32)}}
    ours, n1 = clip_by_global_norm({"a": _t(tree["a"]), "b": {"c": _t(tree["b"]["c"])}}, 1.0)
    theirs, n2 = jax_clip(jax.tree_util.tree_map(jnp.asarray, tree), 1.0)
    assert float(n1) == pytest.approx(float(n2), rel=1e-6)
    np.testing.assert_allclose(ours["a"].numpy(), np.asarray(theirs["a"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ours["b"]["c"].numpy(), np.asarray(theirs["b"]["c"]),
                               rtol=1e-6, atol=1e-7)


def _tree(rng):
    """A model-shaped tree: an embedding table, stacked (n_layers, ...)
    matrices and norm scales, and a final norm vector."""
    return {
        "embed": {"table": rng.standard_normal((32, 8)).astype(np.float32)},
        "layers": {
            "attn": {"wq": rng.standard_normal((3, 8, 8)).astype(np.float32)},
            "attn_norm": {"scale": (1 + 0.1 * rng.standard_normal((3, 8))).astype(np.float32)},
        },
        "final_norm": {"scale": np.ones((8,), np.float32)},
    }


def _to_torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)


def _assert_tree_close(ours, theirs, rtol, atol):
    for path, a in jax.tree_util.tree_leaves_with_path(theirs):
        t = ours
        for k in path:
            t = t[k.key]
        np.testing.assert_allclose(t.float().numpy(), np.asarray(a, np.float32),
                                   rtol=rtol, atol=atol, err_msg=str(path))


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_clip", [1.0, 0.0])
def test_adamw_update_matches_jax_over_three_steps(state_dtype, grad_clip):
    """Same params and gradients on both sides, three steps: params, m, v,
    step, lr and grad_norm. The stacked (n_layers, d) norm scales are
    decayed (two dimensions), the final (d,) scale is not, as in JAX."""
    rng = np.random.default_rng(0)
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=20, weight_decay=0.1,
               grad_clip=grad_clip, state_dtype=state_dtype)
    jopt, opt = JaxAdamW(JaxAdamWConfig(**cfg)), AdamW(AdamWConfig(**cfg))
    params_np = _tree(rng)
    jparams = jax.tree_util.tree_map(jnp.asarray, params_np)
    params = _to_torch(params_np)
    jstate, state = jopt.init(jparams), opt.init(params)
    assert state["m"]["layers"]["attn"]["wq"].dtype == getattr(torch, state_dtype)
    tol = 1e-5 if state_dtype == "float32" else 2e-2
    for _ in range(3):
        grads_np = jax.tree_util.tree_map(
            lambda a: rng.standard_normal(a.shape).astype(np.float32), params_np
        )
        jparams, jstate, jm = jopt.update(jax.tree_util.tree_map(jnp.asarray, grads_np),
                                          jstate, jparams)
        ref_ids = [id(t) for t in jax.tree_util.tree_leaves(params)]
        params, state, m = opt.update(_to_torch(grads_np), state, params)
        assert [id(t) for t in jax.tree_util.tree_leaves(params)] == ref_ids  # in place
        assert int(m["step"]) == int(jm["step"]) == int(state["step"])
        assert float(m["lr"]) == float(jm["lr"])
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        _assert_tree_close(params, jparams, rtol=1e-5, atol=1e-6)
        _assert_tree_close(state["m"], jstate["m"], rtol=tol, atol=tol)
        _assert_tree_close(state["v"], jstate["v"], rtol=tol, atol=tol)
    # decay rule: matrices and the stacked scales move with zero gradient
    zero = jax.tree_util.tree_map(torch.zeros_like, params)
    before = jax.tree_util.tree_map(torch.clone, params)
    opt = AdamW(AdamWConfig(lr=0.1, weight_decay=0.5, grad_clip=0.0, warmup_steps=0,
                            min_lr_ratio=1.0, state_dtype=state_dtype))
    opt.update(zero, opt.init(params), params)
    assert torch.equal(params["final_norm"]["scale"], before["final_norm"]["scale"])
    assert (params["layers"]["attn_norm"]["scale"] < before["layers"]["attn_norm"]["scale"]).all()


def test_state_bytes_are_what_init_allocates():
    params = _to_torch(_tree(np.random.default_rng(1)))
    for sd in ("float32", "bfloat16"):
        opt = AdamW(AdamWConfig(state_dtype=sd))
        assert opt.state_bytes(params) == tensor_bytes(opt.init(params))
    # three fp32 temporaries of the largest piece: the (32, 8) table here
    assert AdamW().update_temp_bytes(params) == 3 * 4 * 32 * 8
