"""Port rwkv6 (CPU path) vs the JAX package on the rwkv6-7b smoke config:
the same params (JAX ``Model.init`` through ``from_jax``, with
``decay_base`` spread so that the decays span about 0.15-0.99 and the
chunk math is exercised) and the same inputs give the same time-mix,
channel-mix, ``apply`` logits, and ``prefill`` logits and recurrent cache,
in fp32 at rtol = atol = 1e-4; once against the JAX model through its
Pallas WKV6 kernel in interpret mode; and in bf16 at 2e-2."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.models import ModelOptions, build_model, rwkv  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

ARCH = "rwkv6-7b"
TOL = dict(rtol=1e-4, atol=1e-4)
CHUNK = 8  # the serve driver's: a 16-token prompt is two chunks


def spread_decay(np_params):
    """decay_base from log(-log 0.99) to log(-log 0.15) across channels."""
    layers = np_params["layers"]["tmix"]
    n, d = layers["decay_base"].shape
    base = np.linspace(np.log(-np.log(0.99)), np.log(-np.log(0.15)), d, dtype=np.float32)
    layers["decay_base"] = np.broadcast_to(base, (n, d)).copy()
    return np_params


@functools.lru_cache(maxsize=None)
def _setup(compute_dtype="float32", kernel_mode="reference"):
    jcfg = jax_get_config(ARCH).smoke()
    jopts = JaxOptions(compute_dtype=compute_dtype, kernel_mode=kernel_mode, wkv_chunk=CHUNK)
    jmodel = jax_build_model(jcfg, jopts)
    np_params = spread_decay(jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(3))))
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tparams = from_jax(np_params, "cpu")
    model = build_model(
        get_config(ARCH).smoke(), ModelOptions(compute_dtype=compute_dtype, wkv_chunk=CHUNK)
    )
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    return jmodel, jparams, model, tparams, tokens


def _layer0(jparams, tparams, name):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"][name])
    tp = {k: leaf[0] for k, leaf in tparams["layers"][name].items()}
    return jp, tp


def _x(d, s=16, seed=12):
    return np.random.default_rng(seed).standard_normal((2, s, d)).astype(np.float32)


def test_decays_are_spread():
    """The decays the tests run with span the chunk math's range."""
    jmodel, jparams, model, tparams, _ = _setup()
    w = np.exp(-np.exp(np.asarray(jparams["layers"]["tmix"]["decay_base"])))
    assert w.min() < 0.2 and w.max() > 0.98


@pytest.mark.parametrize("kernel_mode", ["kernel", "reference"])
def test_tmix_apply_matches_jax(kernel_mode):
    """Output, token-shift carry and wkv state of one time-mix, against the
    JAX chunked path."""
    jmodel, jparams, model, tparams, _ = _setup()
    jp, tp = _layer0(jparams, tparams, "tmix")
    x = _x(model.cfg.d_model)
    jout, (jshift, jstate) = jax_rwkv.tmix_apply(
        jp, jmodel.cfg, jnp.asarray(x), kernel_mode="chunked", chunk=CHUNK, return_state=True
    )
    out, (shift, state) = rwkv.tmix_apply(
        tp, model.cfg, torch.from_numpy(x), kernel_mode=kernel_mode, chunk=CHUNK
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(shift.numpy(), np.asarray(jshift), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


def test_tmix_single_step_carries_state():
    """s == 1 (a decode step) takes the oracle from the given state and
    token-shift carry, as in JAX."""
    jmodel, jparams, model, tparams, _ = _setup()
    jp, tp = _layer0(jparams, tparams, "tmix")
    h, hd = rwkv.rwkv_dims(model.cfg)
    g = np.random.default_rng(13)
    x = _x(model.cfg.d_model, s=1)
    prev = g.standard_normal((2, 1, model.cfg.d_model)).astype(np.float32)
    s0 = g.standard_normal((2, h, hd, hd)).astype(np.float32)
    jout, (_, jstate) = jax_rwkv.tmix_apply(
        jp, jmodel.cfg, jnp.asarray(x), shift_prev=jnp.asarray(prev), s0=jnp.asarray(s0),
        return_state=True,
    )
    out, (_, state) = rwkv.tmix_apply(
        tp, model.cfg, torch.from_numpy(x), shift_prev=torch.from_numpy(prev),
        s0=torch.from_numpy(s0),
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(state.numpy(), np.asarray(jstate), **TOL)


def test_cmix_apply_matches_jax():
    jmodel, jparams, model, tparams, _ = _setup()
    jp, tp = _layer0(jparams, tparams, "cmix")
    x = _x(model.cfg.d_model)
    jout, jshift = jax_rwkv.cmix_apply(jp, jmodel.cfg, jnp.asarray(x), return_state=True)
    out, shift = rwkv.cmix_apply(tp, model.cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_array_equal(shift.numpy(), np.asarray(jshift))


@pytest.mark.parametrize("kernel_mode", ["kernel", "reference"])
def test_apply_matches_jax(kernel_mode):
    jmodel, jparams, _, tparams, tokens = _setup()
    model = build_model(
        get_config(ARCH).smoke(),
        ModelOptions(compute_dtype="float32", wkv_chunk=CHUNK, kernel_mode=kernel_mode),
    )
    jlogits, _ = jmodel.apply(jparams, {"tokens": tokens})
    logits, aux = model.apply(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert logits.shape == jlogits.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_prefill_logits_and_cache_match_jax():
    jmodel, jparams, model, tparams, tokens = _setup()
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": tokens}, max_len=24)
    logits, cache = model.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()}, max_len=24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(cache) == set(jcache) == {"tmix_shift", "cmix_shift", "wkv"}
    for name in cache:
        assert tuple(cache[name].shape) == jcache[name].shape, name
        assert str(cache[name].dtype).removeprefix("torch.") == str(jcache[name].dtype), name
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)


def test_prefill_cache_layout_is_init_state():
    """Prefill fills the layout ``rwkv_init_state`` fixes, as in JAX."""
    cfg = get_config(ARCH).smoke()
    ours = rwkv.rwkv_init_state(cfg, 3, torch.bfloat16, torch.device("cpu"))
    theirs = jax_rwkv.rwkv_init_state(jax_get_config(ARCH).smoke(), 3, jnp.bfloat16)
    assert set(ours) == set(theirs)
    for name, t in ours.items():
        assert tuple(t.shape) == theirs[name].shape and not t.any()
        assert str(t.dtype).removeprefix("torch.") == str(theirs[name].dtype)


def test_apply_matches_jax_pallas_interpret():
    """The JAX model through its Pallas WKV6 kernel (interpret mode)."""
    jmodel, jparams, model, tparams, tokens = _setup(kernel_mode="pallas")
    jlogits, _ = jmodel.apply(jparams, {"tokens": tokens})
    logits, _ = model.apply(tparams, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


def test_prefill_bf16_matches_jax():
    """bf16 compute on both sides: the two frameworks round at other
    places, so 2e-2 as the JAX bf16 kernel tests."""
    jmodel, jparams, model, tparams, tokens = _setup(compute_dtype="bfloat16")
    jlogits, _ = jmodel.prefill(jparams, {"tokens": tokens})
    logits, cache = model.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert logits.dtype == torch.bfloat16 and cache["wkv"].dtype == torch.float32
    assert all(cache[n].dtype == torch.bfloat16 for n in ("tmix_shift", "cmix_shift"))
    np.testing.assert_allclose(
        logits.float().numpy(), np.asarray(jlogits, np.float32), rtol=2e-2, atol=2e-2
    )


def test_kernel_and_reference_modes_agree_on_cpu():
    """On the CPU the kernel mode takes the plain versions: no launch is
    counted, and it agrees with the reference mode's chunked WKV."""
    cfg = get_config(ARCH).smoke()
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(2))}
    opts = dict(compute_dtype="float32", wkv_chunk=CHUNK)
    before = (rms_ops.rmsnorm.launches, wkv_ops.wkv6.launches)
    a, ca = build_model(cfg, ModelOptions(kernel_mode="kernel", **opts)).prefill(params, batch)
    b, cb = build_model(cfg, ModelOptions(kernel_mode="reference", **opts)).prefill(params, batch)
    assert (rms_ops.rmsnorm.launches, wkv_ops.wkv6.launches) == before
    torch.testing.assert_close(a, b, **TOL)
    torch.testing.assert_close(ca["wkv"], cb["wkv"], **TOL)


def test_options_match_jax_defaults():
    """``wkv_chunk`` has the JAX default; the other shared options too."""
    ours, theirs = ModelOptions(), JaxOptions()
    for f in dataclasses.fields(ours):
        if f.name != "kernel_mode":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
