"""The port's SSM branch (``repro_torch/models/ssm.py``), M-RoPE and the
frontends' batches against the JAX package, on the CPU, fp32: every
function of ``models/ssm.py`` on the same inputs (made from a seed with
numpy), at the JAX tests' tolerance of 1e-4
(``tests/test_models.py::TestScans::test_ssm_chunked_vs_ref``); the
chunked scan at a chunk of 8 and at a length it does not divide (the
fallback to the oracle); ``ssm_apply``'s state, for a prompt shorter
than the conv window too; several ``ssm_decode`` steps; M-RoPE with
distinct (t, h, w) ids, where it is not RoPE; and the loss and its
gradients for the three smoke configs of this slice (hymba-1.5b,
qwen2-vl-72b, musicgen-medium)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import ShapeConfig as JaxShape  # noqa: E402
from repro.data.pipeline import make_batch_for as jax_make_batch_for  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models import ssm as jax_ssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.data.pipeline import make_batch_for  # noqa: E402
from repro_torch.models import ModelOptions, build_model, layers, ssm  # noqa: E402
from repro_torch.train.train_step import stack_grads, value_and_grad  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

from chip_smoke import grid_positions  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_models.py::TestScans
FAMILY_ARCHS = ["hymba-1.5b", "qwen2-vl-72b", "musicgen-medium"]
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan_inputs(b, s, c, n, seed=5):
    """The JAX scan test's distributions: dt = softplus(normal), A =
    -exp(0.3 normal), normal B, C and x."""
    g = np.random.default_rng(seed)
    f = lambda *shape: g.standard_normal(shape).astype(np.float32)  # noqa: E731
    dt = np.asarray(jax.nn.softplus(f(b, s, c)))
    a = -np.exp(f(c, n) * 0.3)
    return dt, a, f(b, s, n), f(b, s, n), f(b, s, c)


@pytest.mark.parametrize("s,chunk", [(32, 8), (32, 32), (64, 16), (30, 8)])
def test_ssm_scan_chunked_matches_jax(s, chunk):
    """The doubling scan inside each chunk against JAX's associative scan
    and its oracle (y and the final state); 8 does not divide 30, so that
    case takes the oracle, as JAX's does."""
    inputs = _scan_inputs(2, s, 6, 4)
    y_ref, h_ref = jax_ssm.ssm_scan_ref(*inputs)
    y_jc, h_jc = jax_ssm.ssm_scan_chunked(*inputs, chunk=chunk)
    y, h = ssm.ssm_scan_chunked(*map(_t, inputs), chunk=chunk)
    assert y.dtype == h.dtype == torch.float32
    for ours, theirs in ((y, y_ref), (h, h_ref), (y, y_jc), (h, h_jc)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)
    if s % chunk:  # the fallback is the oracle itself
        y_o, h_o = ssm.ssm_scan_ref(*map(_t, inputs))
        assert torch.equal(y, y_o) and torch.equal(h, h_o)


def test_doubling_scan_keeps_exponents_non_positive_and_long_decays_finite():
    """Strong decays (dt up to 30 against A down to -16): the doubling
    scan's factors are exp of non-positive sums, so nothing overflows and
    the scan matches the oracle."""
    dt, a, b_in, c_in, x = _scan_inputs(1, 64, 4, 16, seed=8)
    dt = dt * 10.0
    a = -np.arange(1, 17, dtype=np.float32)[None, :].repeat(4, 0)
    y, h = ssm.ssm_scan_chunked(*map(_t, (dt, a, b_in, c_in, x)), chunk=64)
    y_o, h_o = ssm.ssm_scan_ref(*map(_t, (dt, a, b_in, c_in, x)))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    torch.testing.assert_close(y, y_o, **TOL)
    torch.testing.assert_close(h, h_o, **TOL)


def test_softplus_is_jaxs():
    """No threshold: equal to ``jax.nn.softplus`` far past F.softplus's 20,
    and within an ulp of it elsewhere."""
    x = np.concatenate([np.linspace(-60, 60, 4001), [19.9, 20.0, 20.1, 88.0, -88.0]])
    x = x.astype(np.float32)
    ours = ssm.softplus(_t(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jax.nn.softplus(x)), rtol=2e-7, atol=1e-30)
    big = x > 20
    np.testing.assert_array_equal(ours[big], torch.nn.functional.softplus(_t(x)).numpy()[big])


def _ssm_params(seed=3):
    """hymba smoke's SSM params from JAX's ``ssm_init``: (cfg, JAX, port)."""
    jcfg = jax_get_config("hymba-1.5b").smoke()
    jp = jax_ssm.ssm_init(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, jp, from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)


def test_ssm_init_matches_jax_layout():
    jcfg, jp, _ = _ssm_params()
    cfg = get_config("hymba-1.5b").smoke()
    assert ssm.ssm_dims(cfg) == jax_ssm.ssm_dims(jcfg)
    ours = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16, (2,))
    assert set(ours) == set(jp)
    for name, leaf in jp.items():
        assert tuple(ours[name].shape) == (2, *leaf.shape), name
        fp32 = name in ("a_log", "dt_bias", "d_skip")
        assert ours[name].dtype == (torch.float32 if fp32 else torch.bfloat16), name
        if fp32:  # deterministic leaves equal JAX's
            np.testing.assert_allclose(ours[name][1].numpy(), np.asarray(leaf), rtol=1e-6)


@pytest.mark.parametrize("s", [16, 12, 2])
def test_ssm_apply_with_state_matches_jax(s):
    """Output, final state and conv state; at s = 2 the prompt is shorter
    than the conv window's k - 1 = 3 slots, and both keep all 2 inputs."""
    jcfg, jp, tp = _ssm_params()
    cfg = get_config("hymba-1.5b").smoke()
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    jout, (jh, jconv) = jax_ssm.ssm_apply(jp, jcfg, x, chunk=4, return_state=True)
    out, (h, conv) = ssm.ssm_apply(tp, cfg, _t(x), chunk=4, return_state=True)
    assert tuple(conv.shape) == jconv.shape == (2, min(s, cfg.ssm_conv - 1), 2 * cfg.d_model)
    for ours, theirs in ((out, jout), (h, jh), (conv, jconv)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_ssm_decode_steps_match_jax_and_the_full_sequence():
    """A 12-token prefix through ``ssm_apply``, then four ``ssm_decode``
    steps from its state, each against JAX's step, and the last against
    the branch over all 16 tokens."""
    jcfg, jp, tp = _ssm_params(seed=4)
    cfg = get_config("hymba-1.5b").smoke()
    x = np.random.default_rng(9).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    _, (jh, jconv) = jax_ssm.ssm_apply(jp, jcfg, x[:, :12], chunk=4, return_state=True)
    _, (h, conv) = ssm.ssm_apply(tp, cfg, _t(x[:, :12]), chunk=4, return_state=True)
    jstate, state = {"conv": jconv, "h": jh}, {"conv": conv, "h": h}
    for t in range(12, 16):
        jout, jstate = jax_ssm.ssm_decode(jp, jcfg, x[:, t : t + 1], jstate)
        out, state = ssm.ssm_decode(tp, cfg, _t(x[:, t : t + 1]), state)
        assert tuple(out.shape) == (2, 1, cfg.d_model)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
        for name in ("conv", "h"):
            np.testing.assert_allclose(state[name].numpy(), np.asarray(jstate[name]), **TOL)
    full = ssm.ssm_apply(tp, cfg, _t(x), chunk=4)
    np.testing.assert_allclose(out[:, 0].numpy(), full[:, -1].numpy(), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssm_init_state_matches_jax(dtype):
    jcfg = jax_get_config("hymba-1.5b").smoke()
    theirs = jax_ssm.ssm_init_state(jcfg, 3, jnp.dtype(dtype))
    ours = ssm.ssm_init_state(get_config("hymba-1.5b").smoke(), 3, getattr(torch, dtype), CPU)
    assert set(ours) == set(theirs)
    for n, t in ours.items():
        assert tuple(t.shape) == theirs[n].shape and str(t.dtype)[6:] == str(theirs[n].dtype)
        assert not t.any()


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("head_dim", [16, 32, 64, 128, 256])
def test_mrope_sections_match_jax(head_dim):
    assert layers.mrope_sections(head_dim) == jax_layers.mrope_sections(head_dim)
    assert sum(layers.mrope_sections(head_dim)) == head_dim // 2
    assert layers.mrope_sections(128) == (16, 24, 24)


@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_jax_on_grid_positions(head_dim):
    """Distinct (t, h, w) ids: M-RoPE equals JAX's and is not RoPE on any
    one axis; with equal ids it is RoPE."""
    x = np.random.default_rng(head_dim).standard_normal((2, 24, 3, head_dim)).astype(np.float32)
    pos = grid_positions(2, 24, 16, 4).numpy()
    ours = layers.apply_mrope(_t(x), _t(pos), 1e4)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_layers.apply_mrope(x, pos, 1e4)),
                               rtol=1e-5, atol=1e-5)
    for axis in range(3):
        rope = layers.apply_rope(_t(x), _t(pos[:, axis]), 1e4)
        assert (ours - rope).abs().max() > 0.1
    same = np.stack([pos[:, 2]] * 3, axis=1)
    torch.testing.assert_close(layers.apply_mrope(_t(x), _t(same), 1e4),
                               layers.apply_rope(_t(x), _t(pos[:, 2]), 1e4), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the frontends' batches, and the loss with its gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_make_batch_for_frontends_match_jax(arch, kind):
    """Frame embeddings, patch embeddings and M-RoPE ids byte for byte."""
    ours = make_batch_for(get_config(arch).smoke(), ShapeConfig("s", kind, 16, 2), 2, 7)
    theirs = jax_make_batch_for(jax_get_config(arch).smoke(), JaxShape("s", kind, 16, 2), 2, 7)
    assert set(ours) == set(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype and ours[k].tobytes() == theirs[k].tobytes(), k


def family_batch(cfg, b, s, seed):
    """numpy inputs of ``cfg``'s frontend: tokens or frame embeddings,
    patch embeddings and grid M-RoPE ids where it takes them, labels."""
    g = np.random.default_rng(seed)
    out = {"labels": g.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.frontend == "audio_frames":
        out["frame_embeds"] = g.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = g.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    if cfg.frontend == "vision_patches":
        n = cfg.n_frontend_tokens
        out["patch_embeds"] = g.standard_normal((b, n, cfg.d_model)).astype(np.float32)
        out["positions"] = grid_positions(b, s, n, 2).numpy()
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(arch):
    """``Model.loss`` and every gradient leaf (hymba's through the
    doubling scan) against ``jax.value_and_grad`` of JAX's loss."""
    opts = dict(compute_dtype="float32", loss_chunk=8, ssm_chunk=8)
    jm = jax_build_model(jax_get_config(arch).smoke(), JaxOptions(**opts))
    m = build_model(get_config(arch).smoke(), ModelOptions(**opts))
    jp = jm.init(jax.random.PRNGKey(2))
    p = from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)
    batch = family_batch(m.cfg, 2, 16, seed=3)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(jp, batch)
    loss, grads = value_and_grad(m, p, {k: _t(v) for k, v in batch.items()})
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    grads = stack_grads(grads)
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(leaves) == len(torch.utils._pytree.tree_leaves(grads))
    for path, want in leaves:
        got = grads
        for k in path:
            got = got[k.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_bf16_error_is_jax_s(arch):
    """bf16 compute moves the logits from fp32 as far in the port as in
    JAX, within 1.1x (relative Frobenius, same params and inputs, 64
    steps; the ratio spans 0.97-1.03 over seeds, where a max |difference|
    spans 0.8-1.5): the port's bf16 numerics are the reference's, the
    per-layer cast of hymba's ``a_log``, ``dt_bias`` and ``d_skip``
    included."""
    cfg = get_config(arch).smoke()
    jp = jax_build_model(jax_get_config(arch).smoke(), JaxOptions()).init(jax.random.PRNGKey(4))
    p = from_jax(jax.tree_util.tree_map(np.asarray, jp), CPU)
    batch = family_batch(cfg, 2, 64, seed=5)
    del batch["labels"]
    logits = {}
    for dtype in ("float32", "bfloat16"):
        opts = dict(compute_dtype=dtype, ssm_chunk=8)
        jm = jax_build_model(jax_get_config(arch).smoke(), JaxOptions(**opts))
        logits["jax", dtype] = np.asarray(jax.jit(jm.apply)(jp, batch)[0], np.float32)
        out = build_model(cfg, ModelOptions(**opts)).apply(p, {k: _t(v) for k, v in batch.items()})
        logits["port", dtype] = out[0].float().numpy()
    err = {pkg: np.linalg.norm(logits[pkg, "bfloat16"] - logits[pkg, "float32"])
           / np.linalg.norm(logits[pkg, "float32"]) for pkg in ("jax", "port")}
    assert 0 < err["port"] <= 1.1 * err["jax"], err


def test_every_jax_arch_builds():
    """The registry holds every arch of the JAX package's, and a model of
    each builds (its smoke config, on the CPU)."""
    from repro.configs import ARCHS as JAX_ARCHS
    from repro_torch.configs import ARCHS

    assert set(ARCHS) == set(JAX_ARCHS)
    for name in ARCHS:
        cfg = get_config(name)
        params = build_model(cfg.smoke()).init(torch.Generator().manual_seed(0))
        assert ("embed" in params) == (cfg.frontend != "audio_frames")
