"""Port model (CPU path) vs the JAX package on the dense smoke configs:
the same params (JAX ``Model.init`` through ``from_jax``) and the same
tokens give the same ``apply`` logits and the same ``prefill`` logits and
K/V cache, in fp32 at rtol = atol = 1e-4. The JAX side runs its reference
attention and, once, its Pallas flash kernel in interpret mode."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402
from repro_torch.weights import from_jax  # noqa: E402

ARCHS = ["gemma-2b", "qwen3-8b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(arch, kernel_mode="reference"):
    jcfg = jax_get_config(arch).smoke()
    jmodel = jax_build_model(jcfg, JaxOptions(compute_dtype="float32", kernel_mode=kernel_mode))
    jparams = jmodel.init(jax.random.PRNGKey(3))
    tparams = from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    model = build_model(get_config(arch).smoke(), ModelOptions(compute_dtype="float32"))
    tokens = np.random.default_rng(11).integers(0, jcfg.vocab_size, (2, 16), dtype=np.int32)
    return jmodel, jparams, model, tparams, tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_copies(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(jcfg.smoke())


def test_unported_arch_raises():
    with pytest.raises(KeyError, match="not yet ported"):
        get_config("rwkv6-7b")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_jax_tree(arch):
    """Same leaf names, shapes and dtypes as the JAX params (values differ:
    torch and JAX draw different numbers from a seed)."""
    jmodel = jax_build_model(jax_get_config(arch).smoke())
    ours = build_model(get_config(arch).smoke()).init(torch.Generator().manual_seed(0))
    abstract = jmodel.abstract_params()
    jflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(abstract)}
    tflat = {jax.tree_util.keystr(p): v for p, v in jax.tree_util.tree_leaves_with_path(ours)}
    assert set(tflat) == set(jflat)
    for key, leaf in jflat.items():
        assert tuple(tflat[key].shape) == leaf.shape, key
        assert str(tflat[key].dtype).removeprefix("torch.") == str(leaf.dtype), key


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax(arch):
    jmodel, jparams, model, tparams, tokens = _setup(arch)
    jlogits, _ = jmodel.apply(jparams, {"tokens": tokens})
    logits, aux = model.apply(tparams, {"tokens": torch.from_numpy(tokens).long()})
    assert logits.shape == jlogits.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    """``max_len`` > prompt: the cache is zero-padded at the end."""
    jmodel, jparams, model, tparams, tokens = _setup(arch)
    jlogits, jcache = jmodel.prefill(jparams, {"tokens": tokens}, max_len=24)
    logits, cache = model.prefill(tparams, {"tokens": torch.from_numpy(tokens).long()}, max_len=24)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert set(cache) == set(jcache) == {"k", "v"}
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)
        assert not cache[name][:, :, 16:].any()


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_apply_matches_jax(arch):
    """One layer's attention (projections, qk-norm, RoPE, causal GQA,
    output projection) on the same input."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention

    jmodel, jparams, model, tparams, _ = _setup(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {name: leaf[0] for name, leaf in tparams["layers"]["attn"].items()}
    x = np.random.default_rng(12).standard_normal((2, 16, jmodel.cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jout = jax_attention.attention_apply(jp, jmodel.cfg, x, pos)
    out = attention.attention_apply(tp, model.cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_jax_pallas_interpret(arch):
    """The JAX model through its Pallas flash kernel (interpret mode)."""
    jmodel, jparams, model, tparams, tokens = _setup(arch, kernel_mode="pallas")
    jlogits, _ = jmodel.apply(jparams, {"tokens": tokens})
    logits, _ = model.apply(tparams, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_kernel_and_reference_modes_agree_on_cpu(arch):
    """On the CPU both modes take the plain versions: identical logits,
    and no kernel launch is counted."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_rmsnorm import ops as rms_ops

    cfg = get_config(arch).smoke()
    params = build_model(cfg).init(torch.Generator().manual_seed(1))
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(2))}
    before = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches)
    a, _ = build_model(cfg, ModelOptions(kernel_mode="kernel")).prefill(params, batch)
    b, _ = build_model(cfg, ModelOptions(kernel_mode="reference")).prefill(params, batch)
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    assert (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches) == before


def test_model_rejects_unknown_kernel_mode():
    with pytest.raises(ValueError):
        build_model(get_config("gemma-2b").smoke(), ModelOptions(kernel_mode="pallas"))
