"""Port MoE layer (``repro_torch.models.moe``, CPU path) vs the JAX
package's ``models/moe.py`` on the mixtral-8x22b and qwen3-moe-235b-a22b
smoke configs: the same params (JAX ``moe_init`` through ``from_jax``) and
inputs (numpy seeds) give the same routing, the same dispatch tables
integer for integer (drops included), and the same output and aux loss,
fp32 at TestMoE's 1e-5 (``tests/test_models.py``), on the single-block
and the multi-block branch; gradients against ``jax.vjp``. Twins of
``tests/test_models.py::TestMoE`` and of ``tests/test_arch_smoke.py``'s
forward and train-step tests close the file."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro_torch.configs import ARCHS as PORTED  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ModelOptions, build_model, moe  # noqa: E402
from repro_torch.train.optimizer import AdamW, AdamWConfig  # noqa: E402
from repro_torch.train.train_step import TrainRunConfig, make_train_step  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

from chip_smoke import dropped, moe_trace  # noqa: E402

MIXTRAL, QWEN3_MOE = "mixtral-8x22b", "qwen3-moe-235b-a22b"
TOL = dict(rtol=1e-5, atol=1e-5)  # tests/test_models.py::TestMoE
# the JAX references, jitted (eager dispatch compiles op by op)
jax_route = jax.jit(jax_moe.route, static_argnums=2)
jax_balance = jax.jit(jax_moe.load_balance_loss, static_argnums=2)
jax_dispatch = jax.jit(jax_moe._dispatch_indices, static_argnums=(1, 2))


@functools.lru_cache(maxsize=None)
def _layer(arch, seed=7):
    """(JAX config, JAX params, port config, port params) of one MoE layer."""
    jcfg = jax_get_config(arch).smoke()
    jp = jax_moe.moe_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, jp, get_config(arch).smoke(), from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# init, capacity, routing, aux loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MIXTRAL, QWEN3_MOE])
def test_moe_init_layout_and_fp32_router(arch, dtype):
    """JAX's leaf names, shapes and dtypes: the router stays fp32 under
    bf16 params; stacked over a leading layer axis like every layer leaf."""
    jcfg, cfg = jax_get_config(arch).smoke(), get_config(arch).smoke()
    want = jax.eval_shape(lambda r: jax_moe.moe_init(r, jcfg, jnp.dtype(dtype)),
                          jax.random.PRNGKey(0))
    got = moe.moe_init(torch.Generator().manual_seed(0), cfg, getattr(torch, dtype), (3,))
    assert set(got) == set(want) == {"router", "w_gate", "w_up", "w_down"}
    for name, leaf in want.items():
        assert tuple(got[name].shape) == (3, *leaf.shape), name
        assert str(got[name].dtype)[6:] == str(leaf.dtype), name
    assert got["router"].dtype == torch.float32
    # the experts are draws of dense_init's scale, not zeros or copies
    w = got["w_gate"].float()
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
    assert not torch.equal(w[0, 0], w[0, 1]) and not torch.equal(w[0], w[1])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MIXTRAL, QWEN3_MOE])
def test_from_jax_carries_the_moe_leaves(arch, param_dtype):
    """A JAX MoE model's params cross leaf for leaf, bit for bit: the
    router ``(L, d, E)`` fp32 under bf16 params too, the experts ``(L, E,
    d, f)`` / ``(L, E, f, d)`` in the param dtype."""
    from repro.models import ModelOptions as JaxOptions
    from repro.models import build_model as jax_build_model

    jcfg = jax_get_config(arch).smoke()
    jp = jax_build_model(jcfg, JaxOptions(param_dtype=param_dtype)).init(jax.random.PRNGKey(1))
    ours = from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")["layers"]["moe"]
    L, e, d, f = jcfg.n_layers, jcfg.n_experts, jcfg.d_model, jcfg.d_ff
    want = {"router": (L, d, e), "w_gate": (L, e, d, f), "w_up": (L, e, d, f), "w_down": (L, e, f, d)}
    assert {n: tuple(t.shape) for n, t in ours.items()} == want
    assert ours["router"].dtype == torch.float32
    for name, leaf in jp["layers"]["moe"].items():
        assert str(ours[name].dtype)[6:] == str(leaf.dtype)
        np.testing.assert_array_equal(ours[name].float().numpy(), np.asarray(leaf, np.float32))


@pytest.mark.parametrize("group,k,e,factor", [
    (16, 2, 4, 8.0), (64, 2, 4, 0.25), (1, 2, 8, 2.0), (4096, 2, 8, 1.25), (512, 8, 128, 1.25),
    (3, 8, 128, 2.0), (16, 2, 8, 1.25)])
def test_default_capacity_matches_jax(group, k, e, factor):
    assert moe.default_capacity(group, k, e, factor) == jax_moe.default_capacity(group, k, e, factor)


@pytest.mark.parametrize("router_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", [MIXTRAL, QWEN3_MOE])
def test_route_matches_jax(arch, router_dtype):
    """Gates, experts (exactly) and probs; a bf16 router (the model casts
    it with the other leaves) is upcast as JAX's einsum promotes it."""
    jcfg, jp, cfg, p = _layer(arch)
    x = _x((2, 24, jcfg.d_model), seed=1)
    jr = jnp.asarray(jp["router"], jnp.dtype(router_dtype))
    g, e, pr = jax_route(jr, x, jcfg.top_k)
    tg, te, tpr = moe.route(torch.from_numpy(np.array(jr, np.float32)).to(getattr(torch, router_dtype)),
                            torch.from_numpy(x), cfg.top_k)
    assert te.dtype == torch.int32 and tg.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(e))
    np.testing.assert_allclose(tg.numpy(), np.asarray(g), **TOL)
    np.testing.assert_allclose(tpr.numpy(), np.asarray(pr), **TOL)


def test_route_ties_go_to_the_lower_expert():
    """Experts with equal probabilities come in index order, as in
    ``jax.lax.top_k``: identical router columns make exact ties."""
    _, _, cfg, _ = _layer(MIXTRAL)
    router = np.repeat(_x((cfg.d_model, 1), seed=2), cfg.n_experts, axis=1)
    router[:, 1] *= 0.5
    x = _x((5, cfg.d_model), seed=3)
    _, e, _ = jax_route(router, x, cfg.top_k)
    _, te, _ = moe.route(torch.from_numpy(router), torch.from_numpy(x), cfg.top_k)
    np.testing.assert_array_equal(te.numpy(), np.asarray(e))
    # a positive logit ties experts 0, 2 and 3 on top, a negative one
    # puts expert 1 first and ties the rest: the lowest indices win
    logit = x @ router[:, 0]
    want = np.where(logit[:, None] > 0, [0, 2], [1, 0])
    assert (logit > 0).any() and (logit < 0).any()
    np.testing.assert_array_equal(te.numpy(), want)


@pytest.mark.parametrize("arch", [MIXTRAL, QWEN3_MOE])
def test_load_balance_loss_matches_jax(arch):
    jcfg, jp, cfg, p = _layer(arch)
    x = _x((3, 40, jcfg.d_model), seed=4)
    _, e, pr = jax_route(jp["router"], x, jcfg.top_k)
    want = jax_balance(pr, e, jcfg.n_experts)
    got = moe.load_balance_loss(torch.from_numpy(np.asarray(pr)), torch.from_numpy(np.asarray(e)),
                                cfg.n_experts)
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(float(want), rel=1e-6)


# ---------------------------------------------------------------------------
# dispatch tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,k,e,cap", [
    (16, 2, 4, 16),  # room for every assignment
    (16, 2, 4, 8),  # drops: 32 assignments, 32 slots, uneven loads
    (32, 2, 4, 8),  # drops
    (64, 2, 4, 8),  # most dropped
    (9, 8, 128, 8),  # qwen3-moe's 128 experts, mostly empty slots
    (5, 2, 8, 8),
])
def test_dispatch_indices_match_jax(s, k, e, cap):
    """Exact int32 tables, with the sentinels S*k and E*C, for random
    top-k assignments (distinct experts a token); a batch of groups at
    once equals JAX's vmap over them."""
    rng = np.random.default_rng(s * 100 + cap)
    idx = np.stack([np.stack([rng.permutation(e)[:k] for _ in range(s)]) for _ in range(3)])
    idx = idx.astype(np.int32)
    for g in range(3):
        jt, js = jax_dispatch(jnp.asarray(idx[g]), e, cap)
        tt, ts = moe._dispatch_indices(torch.from_numpy(idx[g]), e, cap)
        assert tt.dtype == ts.dtype == torch.int32
        assert tuple(tt.shape) == (e, cap) and tuple(ts.shape) == (s * k,)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jt, js = jax.jit(jax.vmap(lambda a: jax_moe._dispatch_indices(a, e, cap)))(jnp.asarray(idx))
    tt, ts = moe._dispatch_indices(torch.from_numpy(idx), e, cap)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    dropped = int((np.asarray(js) == e * cap).sum())
    kept = int((np.asarray(jt) < s * k).sum())
    assert dropped + kept == 3 * s * k
    assert dropped == sum(max(0, int((idx[g] == x).sum()) - cap) for g in range(3) for x in range(e))


def test_dispatch_indices_with_every_token_on_one_expert():
    """All assignments of expert 0 past the capacity are dropped, in flat
    order; the other slots stay empty."""
    idx = np.stack([np.zeros(12), np.arange(12) % 3 + 1], axis=1).astype(np.int32)
    jt, js = jax_dispatch(jnp.asarray(idx), 4, 8)
    tt, ts = moe._dispatch_indices(torch.from_numpy(idx), 4, 8)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tt[0].tolist() == [0, 2, 4, 6, 8, 10, 12, 14]
    assert (ts.numpy() == 32).sum() == 4


# ---------------------------------------------------------------------------
# moe_apply
# ---------------------------------------------------------------------------


def _jax_apply(arch, x, **kw):
    jcfg, jp, _, _ = _layer(arch)
    y, aux = jax.jit(lambda p, a: jax_moe.moe_apply(p, jcfg, a, **kw))(jp, x)
    return np.asarray(y), float(aux)


def _jax_dropped(arch, x, group_size, capacity_factor):
    """JAX's dropped assignments at one group block."""
    jcfg, jp, _, _ = _layer(arch)
    tokens = x.shape[0] * x.shape[1]
    g = min(group_size, tokens)
    while tokens % g:
        g -= 1
    cap = jax_moe.default_capacity(g, jcfg.top_k, jcfg.n_experts, capacity_factor)
    _, e, _ = jax_route(jp["router"], x.reshape(-1, g, x.shape[-1]), jcfg.top_k)
    _, sof = jax.jit(jax.vmap(lambda a: jax_moe._dispatch_indices(a, jcfg.n_experts, cap)))(e)
    return int((np.asarray(sof) == jcfg.n_experts * cap).sum())


@pytest.mark.parametrize("arch,shape,group_size,capacity_factor", [
    (MIXTRAL, (2, 16), 16, 8.0),  # TestMoE's case: no drops
    (QWEN3_MOE, (2, 32), 64, 0.25),  # TestMoE's drops
    (MIXTRAL, (2, 24), 20, 1.25),  # group 16: the largest divisor of 48 <= 20
    (QWEN3_MOE, (2, 1040), 16, 1.25),  # 130 groups: 64 does not divide them, one block
    (MIXTRAL, (1, 5), 4096, 1.25),  # fewer tokens than a group
])
def test_moe_apply_matches_jax(arch, shape, group_size, capacity_factor):
    _, _, cfg, p = _layer(arch)
    x = _x((*shape, cfg.d_model), seed=shape[1])
    kw = dict(group_size=group_size, capacity_factor=capacity_factor)
    want, want_aux = _jax_apply(arch, x, **kw)
    with moe_trace() as log:
        y, aux = moe.moe_apply(p, cfg, torch.from_numpy(x), **kw)
    assert y.shape == x.shape and aux.dtype == torch.float32 and aux.shape == ()
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    assert float(aux) == pytest.approx(want_aux, rel=1e-5, abs=1e-5)
    assert dropped(log) == _jax_dropped(arch, x, group_size, capacity_factor)
    if capacity_factor < 1:
        assert dropped(log) > 0


@pytest.mark.parametrize("arch", [MIXTRAL, QWEN3_MOE])
def test_moe_apply_multi_block_matches_jax(arch):
    """2 x 1024 tokens in groups of 16: 128 groups, two blocks of 64. The
    aux loss is the mean of the blocks' aux losses, as JAX's scan gives,
    not one aux over every group."""
    _, _, cfg, p = _layer(arch)
    x = _x((2, 1024, cfg.d_model), seed=9)
    want, want_aux = _jax_apply(arch, x, group_size=16)
    y, aux = moe.moe_apply(p, cfg, torch.from_numpy(x), group_size=16)
    np.testing.assert_allclose(y.numpy(), want, **TOL)
    assert float(aux) == pytest.approx(want_aux, rel=1e-5, abs=1e-5)
    # one block of all 128 groups: the same output, another aux
    y1, aux1 = moe.moe_apply(p, cfg, torch.from_numpy(x), group_size=16, max_groups_per_block=128)
    np.testing.assert_allclose(y1.numpy(), want, **TOL)
    halves = [moe.moe_apply(p, cfg, torch.from_numpy(x[i : i + 1]), group_size=16)[1]
              for i in range(2)]
    assert float(aux) == pytest.approx(float(sum(halves)) / 2, rel=1e-6)
    assert abs(float(aux1) - float(aux)) > 1e-6


@pytest.mark.parametrize("arch,group_size,capacity_factor", [
    (MIXTRAL, 16, 8.0), (QWEN3_MOE, 64, 0.25)])
def test_moe_apply_grads_match_jax_vjp(arch, group_size, capacity_factor):
    """The gradients of ``<y, dy> + daux * aux`` wrt the input and every
    param (router through the gates and the aux loss), against
    ``jax.vjp``."""
    jcfg, jp, cfg, p = _layer(arch)
    x = _x((2, 32, cfg.d_model), seed=5)
    dy = _x(x.shape, seed=6)
    daux = 0.37
    kw = dict(group_size=group_size, capacity_factor=capacity_factor)
    f = lambda pp, a: jax_moe.moe_apply(pp, jcfg, a, **kw)  # noqa: E731
    jgp, jgx = jax.jit(lambda pp, a, c: jax.vjp(f, pp, a)[1](c))(
        jp, jnp.asarray(x), (jnp.asarray(dy), jnp.asarray(daux, jnp.float32)))
    names = sorted(p)
    leaves = [p[n].clone().requires_grad_() for n in names]
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(dict(zip(names, leaves)), cfg, tx, **kw)
    grads = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + daux * aux, [tx, *leaves])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgx), **TOL)
    for name, g in zip(names, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]), **TOL, err_msg=name)
    assert float(grads[1 + names.index("router")].abs().max()) > 0


def test_moe_reference_matches_jax():
    jcfg, jp, cfg, p = _layer(QWEN3_MOE)
    x = _x((2, 8, cfg.d_model), seed=8)
    want, want_aux = jax.jit(lambda pp, a: jax_moe.moe_reference(pp, jcfg, a))(jp, x)
    y, aux = moe.moe_reference(p, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    assert float(aux) == pytest.approx(float(want_aux), rel=1e-6)


def _untraced():
    """``moe_trace`` has put back the module's own functions."""
    return moe.route.__module__ == moe.__name__ and moe._dispatch_indices.__module__ == moe.__name__


def test_routing_log_is_scoped_and_counts_drops():
    """``chip_smoke.moe_trace``: only the blocks run inside a log are
    kept, nested logs both keep them, a multi-block run keeps one entry a
    block, and ``dropped`` counts what the dispatch dropped; nothing stays
    traced afterwards."""
    _, _, cfg, p = _layer(QWEN3_MOE)
    x = torch.from_numpy(_x((2, 32, cfg.d_model), seed=32))
    kw = dict(group_size=64, capacity_factor=0.25)
    with moe_trace() as outer:
        moe.moe_apply(p, cfg, x, **kw)
        with moe_trace() as inner:
            moe.moe_apply(p, cfg, x, **kw)
    moe.moe_apply(p, cfg, x, **kw)
    assert len(outer) == 2 and len(inner) == 1
    assert inner[0].experts.shape == (1, 64, cfg.top_k) and inner[0].experts.dtype == torch.int32
    assert inner[0][1:] == (cfg.n_experts, moe.default_capacity(64, cfg.top_k, cfg.n_experts, 0.25))
    assert dropped(inner) > 0 and dropped(outer) == 2 * dropped(inner)
    assert dropped([]) == 0
    with moe_trace() as blocks:
        moe.moe_apply(p, cfg, torch.from_numpy(_x((2, 1024, cfg.d_model), seed=9)), group_size=16)
    assert [r.experts.shape[0] for r in blocks] == [64, 64]
    assert _untraced()


def test_record_and_replay_routing():
    """``chip_smoke.moe_trace``: a run replaying its own recorded routing
    gives the same output; a
    bf16 run replaying an fp32 run's routing takes the fp32 run's experts
    (gates from its own probabilities); a block the log does not fit
    raises, and nothing stays open afterwards."""
    _, _, cfg, p = _layer(QWEN3_MOE)
    x = torch.from_numpy(_x((2, 32, cfg.d_model), seed=33))
    kw = dict(group_size=16, capacity_factor=1.25)
    with moe_trace() as log:
        y, aux = moe.moe_apply(p, cfg, x, **kw)
    assert len(log) == 1 and log[0].experts.shape == (4, 16, cfg.top_k)
    with moe_trace(log):
        y2, aux2 = moe.moe_apply(p, cfg, x, **kw)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    p16 = {n: t.bfloat16() for n, t in p.items()}
    with moe_trace() as log16, moe_trace(log):
        y16, _ = moe.moe_apply(p16, cfg, x.bfloat16(), **kw)
    assert torch.equal(log16[0].experts, log[0].experts) and y16.dtype == torch.bfloat16
    np.testing.assert_allclose(y16.float().numpy(), y.numpy(), rtol=5e-2, atol=5e-2)
    with pytest.raises(RuntimeError, match="moe_trace"), moe_trace(log):
        moe.moe_apply(p, cfg, x, **kw)
        moe.moe_apply(p, cfg, x, **kw)  # a second block: nothing left to replay
    with pytest.raises(RuntimeError, match="moe_trace"), moe_trace(log):
        moe.moe_apply(p, cfg, x[:1], **kw)  # another shape
    with pytest.raises(RuntimeError, match="moe_trace"), moe_trace(log):
        moe.moe_apply(p, cfg, x, group_size=16, capacity_factor=4.0)  # another capacity
    assert _untraced()


# ---------------------------------------------------------------------------
# twins of tests/test_models.py::TestMoE
# ---------------------------------------------------------------------------


class TestMoETwins:
    def test_dispatch_matches_dense_reference(self):
        _, _, cfg, p = _layer(MIXTRAL)
        x = torch.from_numpy(_x((2, 16, cfg.d_model), seed=16))
        y1, aux1 = moe.moe_apply(p, cfg, x, group_size=16, capacity_factor=8.0)
        y2, aux2 = moe.moe_reference(p, cfg, x)
        np.testing.assert_allclose(y1.numpy(), y2.numpy(), **TOL)
        assert float(aux1) == pytest.approx(float(aux2), rel=1e-5)

    def test_capacity_drops_are_graceful(self):
        """Tiny capacity drops tokens (gate contribution zero), never NaNs."""
        _, _, cfg, p = _layer(QWEN3_MOE, seed=9)
        x = torch.from_numpy(_x((2, 32, cfg.d_model), seed=10))
        y, aux = moe.moe_apply(p, cfg, x, group_size=64, capacity_factor=0.25)
        assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(aux))
        y_full, _ = moe.moe_apply(p, cfg, x, group_size=64, capacity_factor=8.0)
        assert float(y.norm()) <= float(y_full.norm()) + 1e-3

    def test_aux_loss_balanced_is_one(self):
        """Uniform routing probabilities give aux loss ~= top_k."""
        cfg = get_config(MIXTRAL).smoke()
        t, e, k = 512, cfg.n_experts, cfg.top_k
        probs = torch.full((t, e), 1.0 / e)
        idx = torch.randint(0, e, (t, k), generator=torch.Generator().manual_seed(0))
        loss = moe.load_balance_loss(probs, idx, e)
        assert float(loss) == pytest.approx(k, rel=0.1)


# ---------------------------------------------------------------------------
# twins of tests/test_arch_smoke.py's forward and train-step tests
# ---------------------------------------------------------------------------

SMOKE_OPTS = dict(loss_chunk=8, moe_group=16, wkv_chunk=8, ssm_chunk=8, compute_dtype="float32")


def _tiny_batch(cfg, b=2, s=16, seed=1):
    """tests/conftest.py's ``tiny_batch`` inputs: frame embeddings in
    place of tokens for audio, patch embeddings for vision, equal (t, h,
    w) ids under M-RoPE."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        batch = {"frame_embeds": torch.from_numpy(
            rng.standard_normal((b, s, cfg.d_model)).astype(np.float32))}
    else:
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))}
    batch["labels"] = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    if cfg.frontend == "vision_patches":
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((b, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))
    if cfg.rope_variant == "mrope":
        batch["positions"] = torch.arange(s).expand(b, 3, s)
    return batch


@pytest.mark.parametrize("name", sorted(PORTED))
def test_smoke_forward_shapes_and_finite(name):
    cfg = get_config(name).smoke()
    model = build_model(cfg, ModelOptions(**SMOKE_OPTS))
    params = model.init(torch.Generator().manual_seed(0))
    logits, aux = model.apply(params, _tiny_batch(cfg))
    assert logits.shape == (2, 16, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    assert (float(aux) > 0) == cfg.is_moe


@pytest.mark.parametrize("name", sorted(PORTED))
def test_smoke_train_step(name):
    cfg = get_config(name).smoke()
    model = build_model(cfg, ModelOptions(**SMOKE_OPTS))
    opt = AdamW(AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    params = model.init(torch.Generator().manual_seed(0))
    before = [t.clone() for t in torch.utils._pytree.tree_leaves(params)]
    router = params["layers"]["moe"]["router"].clone() if cfg.is_moe else None
    step = make_train_step(model, opt, TrainRunConfig(num_microbatches=2))
    params2, _, metrics = step(params, opt.init(params), _tiny_batch(cfg))
    assert np.isfinite(float(metrics["loss"]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0
    after = torch.utils._pytree.tree_leaves(params2)
    assert any(float((a - b).abs().max()) > 0 for a, b in zip(after, before))
    if cfg.is_moe:  # the router learns through the gates and the aux loss
        assert not torch.equal(params2["layers"]["moe"]["router"], router)
