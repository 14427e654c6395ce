"""Port model (CPU path) vs the JAX package on the dense and MoE smoke
configs: the same params (JAX ``Model.init`` through ``from_jax``) and the
same tokens give the same ``apply`` logits (and MoE aux loss) and the same
``prefill`` logits and K/V cache, in fp32 at rtol = atol = 1e-4. The JAX
side runs its reference attention and, once, its Pallas flash kernel in
interpret mode. The QKV-bias configs (qwen1.5-32b, qwen2-72b) get random
biases in place of the init's zeros, so that their bias branch does work.
The MoE configs route groups of 16 tokens, and their prefill takes a
40-token prompt: past mixtral's smoke window of 32 and no multiple of it,
so the ring cache is rolled. So does hymba-1.5b's (window 32, SSM chunks
of 8); qwen2-vl-72b takes patch embeddings and distinct grid M-RoPE ids,
musicgen-medium frame embeddings (``test_torch_ssm.family_batch``)."""
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
from test_torch_ssm import FAMILY_ARCHS, family_batch  # noqa: E402

ARCHS = ["gemma-2b", "qwen3-8b"]
QKV_BIAS_ARCHS = ["qwen1.5-32b", "qwen2-72b"]
MOE_ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b"]
TOL = dict(rtol=1e-4, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _setup(arch, kernel_mode="reference"):
    """(JAX model, JAX params, port model, port params, numpy batch)."""
    jcfg = jax_get_config(arch).smoke()
    moe = dict(moe_group=16) if jcfg.is_moe else {}
    if jcfg.family == "hybrid":
        moe = dict(ssm_chunk=8)
    jmodel = jax_build_model(
        jcfg, JaxOptions(compute_dtype="float32", kernel_mode=kernel_mode, **moe))
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    if jcfg.qkv_bias:
        g = np.random.default_rng(4)
        attn = np_params["layers"]["attn"]
        for name in ("bq", "bk", "bv"):
            attn[name] = (0.5 * g.standard_normal(attn[name].shape)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jax.numpy.asarray, np_params)
    tparams = from_jax(np_params, "cpu")
    model = build_model(get_config(arch).smoke(), ModelOptions(compute_dtype="float32", **moe))
    seq = 40 if jcfg.is_moe or jcfg.sliding_window else 16
    if arch in FAMILY_ARCHS:
        batch = family_batch(jcfg, 2, seq, seed=11)
        del batch["labels"]
    else:
        batch = {"tokens": np.random.default_rng(11).integers(
            0, jcfg.vocab_size, (2, seq), dtype=np.int32)}
    return jmodel, jparams, model, tparams, batch


def _torch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS + ["rwkv6-7b"] + QKV_BIAS_ARCHS + MOE_ARCHS + FAMILY_ARCHS)
def test_configs_are_copies(arch):
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()
    assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(jcfg.smoke())


def test_unported_arch_raises():
    """Every arch of the JAX registry is ported: only an unknown name
    raises, with or without the smoke suffix."""
    for name in ("hymba-2b", "hymba-2b-smoke"):
        with pytest.raises(KeyError, match="unknown arch"):
            get_config(name)


@pytest.mark.parametrize("arch", ARCHS + ["rwkv6-7b"] + QKV_BIAS_ARCHS + MOE_ARCHS + FAMILY_ARCHS)
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


@pytest.mark.parametrize("arch", ARCHS + QKV_BIAS_ARCHS + FAMILY_ARCHS)
def test_apply_matches_jax(arch):
    jmodel, jparams, model, tparams, batch = _setup(arch)
    jlogits, _ = jmodel.apply(jparams, batch)
    logits, aux = model.apply(tparams, _torch(batch))
    assert logits.shape == jlogits.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_logits_and_aux_match_jax(arch):
    """Logits and the mean of the layers' load-balance losses."""
    jmodel, jparams, model, tparams, batch = _setup(arch)
    tokens = batch["tokens"]
    jlogits, jaux = jax.jit(jmodel.apply)(jparams, {"tokens": tokens})
    logits, aux = model.apply(tparams, {"tokens": torch.from_numpy(tokens).long()})
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5) and float(aux) > 0


@pytest.mark.parametrize("arch", ARCHS + QKV_BIAS_ARCHS + MOE_ARCHS + FAMILY_ARCHS)
def test_prefill_logits_and_cache_match_jax(arch):
    """``max_len`` > prompt: the cache is zero-padded at the end. A
    sliding window shorter than the prompt keeps a ring of the last
    ``window`` tokens, token p in slot p % window. hymba's cache also
    holds the SSM state (``h``, ``conv``)."""
    jmodel, jparams, model, tparams, batch = _setup(arch)
    seq = next(iter(batch.values())).shape[1]
    jlogits, jcache = jmodel.prefill(jparams, batch, max_len=seq + 8)
    logits, cache = model.prefill(tparams, _torch(batch), max_len=seq + 8)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    ssm_state = {"h", "conv"} if model.cfg.family == "hybrid" else set()
    assert set(cache) == set(jcache) == {"k", "v"} | ssm_state
    for name in ssm_state:
        assert tuple(cache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)
    window = model.cfg.sliding_window
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == jcache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache[name]), **TOL)
        if window:  # mixtral, hymba: a ring of 32 rolled by 40 % 32
            assert cache[name].shape[2] == window < seq and seq % window
        else:
            assert not cache[name][:, :, seq:].any()


@pytest.mark.parametrize("arch", ARCHS + QKV_BIAS_ARCHS + ["qwen2-vl-72b"])
def test_attention_apply_matches_jax(arch):
    """One layer's attention (projections, qk-norm, RoPE or M-RoPE on grid
    ids, causal GQA, output projection) on the same input."""
    from repro.models import attention as jax_attention
    from repro_torch.models import attention
    from chip_smoke import grid_positions

    jmodel, jparams, model, tparams, _ = _setup(arch)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["layers"]["attn"])
    tp = {name: leaf[0] for name, leaf in tparams["layers"]["attn"].items()}
    x = np.random.default_rng(12).standard_normal((2, 16, jmodel.cfg.d_model)).astype(np.float32)
    if model.cfg.rope_variant == "mrope":
        pos = grid_positions(2, 16, 4, 2).numpy()
    else:
        pos = np.broadcast_to(np.arange(16, dtype=np.int32), (2, 16))
    jout = jax_attention.attention_apply(jp, jmodel.cfg, x, pos)
    out = attention.attention_apply(tp, model.cfg, torch.from_numpy(x), torch.from_numpy(pos.copy()))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)


@pytest.mark.parametrize("arch", ARCHS + ["mixtral-8x22b", "hymba-1.5b"])
def test_apply_matches_jax_pallas_interpret(arch):
    """The JAX model through its Pallas flash kernel (interpret mode)."""
    jmodel, jparams, model, tparams, batch = _setup(arch, kernel_mode="pallas")
    jlogits, _ = jmodel.apply(jparams, batch)
    logits, _ = model.apply(tparams, _torch(batch))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)


@pytest.mark.parametrize("arch", ARCHS + MOE_ARCHS + ["hymba-1.5b"])
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


def test_device_is_a_required_argument():
    """No helper quietly places tensors on the CPU."""
    from repro_torch.models.layers import positions_from_tokens, rope_frequencies

    with pytest.raises(TypeError):
        positions_from_tokens(2, 4)
    with pytest.raises(TypeError):
        rope_frequencies(16, 10_000.0)
    with pytest.raises(TypeError):
        from_jax({"w": np.zeros(2, np.float32)})
    assert positions_from_tokens(2, 4, device="cpu").shape == (2, 4)
    assert rope_frequencies(16, 10_000.0, "cpu").shape == (8,)
    assert from_jax({"w": np.zeros(2, np.float32)}, "cpu")["w"].device.type == "cpu"
