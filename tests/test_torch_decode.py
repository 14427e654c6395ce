"""Port decode (CPU path) vs the JAX package on the smoke configs: the same
params (JAX ``Model.init`` through ``from_jax``, QKV biases and rwkv
decays spread so that those branches do work) and the same tokens give
the same prefill-then-decode logits and caches, fp32, at the JAX tests'
tolerances: 2e-4 for decode consistency
(``tests/test_arch_smoke.py::test_smoke_decode_consistency``), the int8
bounds of ``tests/test_kv_quant.py``, and 5e-3 through a ring cache's
wrap (``tests/test_paper_scenarios.py``). The JAX references are jitted
and shared across cases. The MoE configs (mixtral-8x22b with its sliding
window, qwen3-moe-235b-a22b) decode through ``block_decode``'s MoE branch:
one routing group of the batch's tokens at capacity factor 2. hymba-1.5b
carries its SSM state (``h``, ``conv``) beside a ring of 32, in SSM
chunks of 8; qwen2-vl-72b takes patch embeddings and distinct grid
M-RoPE ids ((b, 3, 1) a decode step), musicgen-medium frame embeddings
(``test_torch_ssm.family_batch``)."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import ModelOptions as JaxOptions  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.train import runtime as jax_runtime  # noqa: E402
from repro.train.serve_step import greedy_generate as jax_greedy_generate  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.models import ModelOptions, attention, build_model  # noqa: E402
from repro_torch.models.model import unstack_cache  # noqa: E402
from repro_torch.train import runtime  # noqa: E402
from repro_torch.train.serve_step import (  # noqa: E402
    greedy_generate,
    make_decode_step,
    make_prefill_step,
    sample_token,
)
from repro_torch.weights import from_jax  # noqa: E402
from test_torch_ssm import FAMILY_ARCHS, family_batch  # noqa: E402

from chip_smoke import steps  # noqa: E402

ARCHS = ["gemma-2b", "qwen3-8b", "rwkv6-7b", "qwen1.5-32b", "qwen2-72b", "mixtral-8x22b",
         "qwen3-moe-235b-a22b"] + FAMILY_ARCHS
TOL = dict(rtol=2e-4, atol=2e-4)  # test_arch_smoke.py::test_smoke_decode_consistency
RING_TOL = dict(rtol=5e-3, atol=5e-3)  # test_paper_scenarios.py::TestRingCacheWrap
B, S = 2, 16
CPU = torch.device("cpu")


def _spread(np_params, cfg):
    """Nonzero QKV biases (the init's zeros would leave the branch
    untested) and rwkv decays spread over 0.15-0.99."""
    layers = np_params["layers"]
    g = np.random.default_rng(5)
    if cfg.qkv_bias:
        for name in ("bq", "bk", "bv"):
            leaf = layers["attn"][name]
            layers["attn"][name] = (0.5 * g.standard_normal(leaf.shape)).astype(leaf.dtype)
    if cfg.family == "ssm":
        n, d = layers["tmix"]["decay_base"].shape
        base = np.linspace(np.log(-np.log(0.99)), np.log(-np.log(0.15)), d, dtype=np.float32)
        layers["tmix"]["decay_base"] = np.broadcast_to(base, (n, d)).copy()
    return np_params


@functools.lru_cache(maxsize=None)
def _setup(arch, sliding_window=0, seed=0):
    """(JAX model, JAX params, port config, port params, tokens (B, S + 8))."""
    jcfg = jax_get_config(arch).smoke()
    cfg = get_config(arch).smoke()
    if sliding_window:
        jcfg = dataclasses.replace(jcfg, sliding_window=sliding_window)
        cfg = dataclasses.replace(cfg, sliding_window=sliding_window)
    jmodel = jax_build_model(jcfg, _jax_opts())
    np_params = jax.tree_util.tree_map(np.asarray, jmodel.init(jax.random.PRNGKey(seed)))
    np_params = _spread(np_params, jcfg)
    jparams = jax.tree_util.tree_map(jnp.asarray, np_params)
    tokens = np.random.default_rng(seed + 1).integers(0, jcfg.vocab_size, (B, S + 8), dtype=np.int32)
    return jmodel, jparams, cfg, from_jax(np_params, "cpu"), tokens


@functools.lru_cache(maxsize=None)
def _inputs(arch):
    """numpy inputs of ``B`` sequences of ``S + 8`` steps: ``_setup``'s
    tokens, or the frontend's (``family_batch``: frame embeddings, patch
    embeddings and grid M-RoPE ids)."""
    cfg = _setup(arch)[2]
    if arch not in FAMILY_ARCHS or cfg.frontend == "none":
        return {"tokens": _setup(arch)[4]}
    batch = family_batch(cfg, B, S + 8, seed=1)
    del batch["labels"]
    return batch


def _torch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if v.dtype == np.int32
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


# MoE routes groups of 16, as tests/test_arch_smoke.py does: a smoke
# group of 16 has room for every assignment (capacity 16), so the full
# forward drops none and decode can equal it
def _jax_opts(**kw):
    return JaxOptions(compute_dtype="float32", param_dtype="float32", wkv_chunk=8,
                      loss_chunk=8, moe_group=16, ssm_chunk=8, **kw)


def _model(cfg, **kw):
    return build_model(cfg, ModelOptions(compute_dtype="float32", wkv_chunk=8, moe_group=16,
                                         ssm_chunk=8, **kw))


def _t(a):
    return torch.from_numpy(np.asarray(a)).long()


def _np(t):
    return t.float().numpy() if t.dtype in (torch.bfloat16, torch.float16) else t.numpy()


def _stacked(cache):
    if isinstance(cache, dict):
        return cache
    return {n: torch.stack([c[n] for c in cache]) for n in cache[0]}


@functools.lru_cache(maxsize=None)
def _jax_decode(arch):
    """JAX: full-forward logits, prefill of S - 1 tokens (max_len S) and
    one decode step: its logits and its new cache."""
    jmodel, jparams, _, _, _ = _setup(arch)
    batch = _inputs(arch)
    full, _ = jax.jit(jmodel.apply)(jparams, steps(batch, 0, S))
    pre_logits, cache = jax.jit(lambda p, b: jmodel.prefill(p, b, max_len=S))(
        jparams, steps(batch, 0, S - 1))
    logits, new = jax.jit(jmodel.decode)(
        jparams, steps(batch, S - 1, S), cache, jnp.asarray(S - 1, jnp.int32))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return to_np(full), to_np(pre_logits), to_np(logits), to_np(new)


# ---------------------------------------------------------------------------
# decode consistency: prefill(s - 1) + decode(1) == full forward, and == JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kernel_mode", ["kernel", "reference"])
@pytest.mark.parametrize("cache_mode,stacked", [
    ("carry", True), ("carry", False), ("stream", True), ("stream", False)])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistency_matches_jax(arch, cache_mode, stacked, kernel_mode):
    """Logits and the new cache equal JAX's; the decode logits equal the
    port's own full forward at the last position. ``carry`` updates the
    given cache in place, ``stream`` leaves it as it was."""
    jfull, jpre, jlogits, jcache = _jax_decode(arch)
    _, _, cfg, params, _ = _setup(arch)
    batch = _inputs(arch)
    model = _model(cfg, decode_cache_mode=cache_mode, kernel_mode=kernel_mode)
    full, _ = model.apply(params, _torch(steps(batch, 0, S)))
    pre_logits, cache = model.prefill(params, _torch(steps(batch, 0, S - 1)), max_len=S)
    np.testing.assert_allclose(pre_logits.numpy(), jpre, **TOL)
    np.testing.assert_allclose(pre_logits.numpy(), full[:, S - 2].numpy(), **TOL)
    if not stacked:
        cache = unstack_cache(cache, cfg.n_layers)
        assert len(cache) == cfg.n_layers
    before = {n: t.clone() for n, t in _stacked(cache).items()}
    logits, new = model.decode(params, _torch(steps(batch, S - 1, S)), cache, S - 1)
    assert logits.shape == (B, 1, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), jlogits, **TOL)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, S - 1].numpy(), **TOL)
    assert isinstance(new, dict) == stacked
    new = _stacked(new)
    assert set(new) == set(jcache)
    for n, t in new.items():
        assert tuple(t.shape) == jcache[n].shape and str(t.dtype)[6:] == str(jcache[n].dtype)
        np.testing.assert_allclose(t.numpy(), jcache[n], **TOL)
    after = _stacked(cache)
    changed = any(not torch.equal(after[n], before[n]) for n in before)
    assert changed == (cache_mode == "carry")
    if cache_mode == "carry" and stacked:
        assert all(new[n] is cache[n] for n in new)


def test_decode_launches_no_kernel_on_the_cpu():
    _, _, cfg, params, tokens = _setup("qwen3-8b")
    model = _model(cfg)
    _, cache = model.prefill(params, {"tokens": _t(tokens[:, :4])}, max_len=8)
    before = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches, wkv_ops.wkv6.launches)
    model.decode(params, {"tokens": _t(tokens[:, 4:5])}, cache, 4)
    assert (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches,
            wkv_ops.wkv6.launches) == before


def test_decode_cache_mode_is_checked():
    with pytest.raises(ValueError, match="decode_cache_mode"):
        _model(get_config("gemma-2b").smoke(), decode_cache_mode="donate")


@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ["gemma-2b", "rwkv6-7b", "hymba-1.5b"])
def test_init_cache_matches_jax_layout(arch, stacked):
    """Leaf names, shapes and dtypes of ``init_cache``, all zeros."""
    jmodel = jax_build_model(jax_get_config(arch).smoke(), JaxOptions())
    theirs = jmodel.init_cache(3, 24, stacked=stacked)
    ours = build_model(get_config(arch).smoke()).init_cache(3, 24, stacked=stacked, device=CPU)
    assert isinstance(ours, dict) == stacked and len(ours) == len(theirs)
    for o, t in ([(ours, theirs)] if stacked else zip(ours, theirs)):
        assert set(o) == set(t)
        for n in o:
            assert tuple(o[n].shape) == t[n].shape and not o[n].any()
            assert str(o[n].dtype)[6:] == str(t[n].dtype)


# ---------------------------------------------------------------------------
# attention_decode's plain paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("cap,chunk", [(64, 16), (60, 16)])
def test_decode_attention_chunked_matches_jax(cap, chunk, quantized):
    """The online-softmax scan over cache chunks (and its fallback when
    the chunk does not divide the capacity), int8 or not."""
    g = np.random.default_rng(7)
    b, hq, hkv, d = 2, 4, 2, 16
    q = g.standard_normal((b, 1, hq, d)).astype(np.float32)
    k = g.standard_normal((b, cap, hkv, d)).astype(np.float32)
    v = g.standard_normal((b, cap, hkv, d)).astype(np.float32)
    mask = np.broadcast_to(np.arange(cap) < cap - 5, (b, cap))
    scales = tscales = None
    if quantized:
        (k, ks), (v, vs) = jax_attention.quantize_kv(k), jax_attention.quantize_kv(v)
        scales = (ks, vs)
        tscales = tuple(torch.from_numpy(np.array(s)) for s in scales)
        k, v = np.array(k), np.array(v)
    want = jax_attention.decode_attention_chunked(
        q, k, v, mask, chunk=chunk, scales=scales, out_dtype=jnp.float32)
    got = attention.decode_attention_chunked(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(mask.copy()), chunk=chunk, scales=tscales, out_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_long_cache_takes_the_chunked_scan(kv_quantized):
    """At ``cap >= 8192`` decode scans 2048-slot chunks (int8 or not), as
    JAX does; the kernel path reads the valid prefix instead."""
    jmodel, jparams, cfg, params, tokens = _setup("qwen3-8b")
    jm = jax_build_model(jmodel.cfg, _jax_opts(kv_quantized=kv_quantized))
    tok = tokens[:, :S]
    _, jc = jm.prefill(jparams, {"tokens": tok[:, : S - 1]}, max_len=8192)
    want, _ = jax.jit(jm.decode)(jparams, {"tokens": tok[:, S - 1 :]}, jc,
                                 jnp.asarray(S - 1, jnp.int32))
    for kernel_mode in ("reference", "kernel"):
        m = _model(cfg, kv_quantized=kv_quantized, kernel_mode=kernel_mode)
        _, c = m.prefill(params, {"tokens": _t(tok[:, : S - 1])}, max_len=8192)
        got, _ = m.decode(params, {"tokens": _t(tok[:, S - 1 :])}, c, S - 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-72b"])
def test_linear_cache_past_capacity_overwrites_its_last_slot(arch):
    """A full linear cache keeps writing slot ``cap - 1`` (the JAX rule,
    ported as it is): three steps past it, logits and cache as JAX's."""
    jmodel, jparams, cfg, params, tokens = _setup(arch)
    model = _model(cfg)
    _, jc = jmodel.prefill(jparams, {"tokens": tokens[:, :S]}, max_len=S)
    _, c = model.prefill(params, {"tokens": _t(tokens[:, :S])}, max_len=S)
    dec = jax.jit(jmodel.decode)
    for pos in range(S, S + 3):
        jl, jc = dec(jparams, {"tokens": tokens[:, pos : pos + 1]}, jc, jnp.asarray(pos, jnp.int32))
        logits, c = model.decode(params, {"tokens": _t(tokens[:, pos : pos + 1])}, c, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for n in ("k", "v"):
            assert c[n].shape[2] == S
            np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)


def test_ring_cache_prefill_roll_and_decode_through_the_wrap():
    """gemma-2b smoke with a window of 8 (a ring of 8 slots): a 13-token
    prompt lands rolled (token p in slot p % 8), then seven decode steps;
    and decode from an empty ring through the wrap, token by token, held
    against JAX and against the port's own windowed full forward."""
    jmodel, jparams, cfg, params, tokens = _setup("gemma-2b", sliding_window=8)
    model = _model(cfg)
    dec = jax.jit(jmodel.decode)
    _, jc = jmodel.prefill(jparams, {"tokens": tokens[:, :13]}, max_len=24)
    _, c = model.prefill(params, {"tokens": _t(tokens[:, :13])}, max_len=24)
    assert c["k"].shape[2] == 8
    for n in ("k", "v"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)
    for pos in range(13, 20):
        jl, jc = dec(jparams, {"tokens": tokens[:, pos : pos + 1]}, jc, jnp.asarray(pos, jnp.int32))
        logits, c = model.decode(params, {"tokens": _t(tokens[:, pos : pos + 1])}, c, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    n = 20
    full, _ = model.apply(params, {"tokens": _t(tokens[:, :n])})
    jc = jmodel.init_cache(B, n)
    c = model.init_cache(B, n, device=CPU)
    for pos in range(n):
        jl, jc = dec(jparams, {"tokens": tokens[:, pos : pos + 1]}, jc, jnp.asarray(pos, jnp.int32))
        logits, c = model.decode(params, {"tokens": _t(tokens[:, pos : pos + 1])}, c, pos)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **RING_TOL)
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, -1].numpy(), **RING_TOL)


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_mixtral_ring_prefill_roll_and_decode_through_the_wrap(kv_quantized):
    """mixtral smoke, its own window of 32 (a ring of 32 slots): a 40-token
    prompt (past the window, no multiple of it) lands rolled, then decode
    steps from slot 8 on, the MoE branch routing each step's batch as one
    group; logits and caches against JAX's, bf16/fp32 or int8."""
    jmodel, jparams, cfg, params, _ = _setup("mixtral-8x22b")
    jm = jax_build_model(jmodel.cfg, _jax_opts(kv_quantized=kv_quantized))
    model = _model(cfg, kv_quantized=kv_quantized)
    tokens = np.random.default_rng(40).integers(0, cfg.vocab_size, (B, 44), dtype=np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": tokens[:, :40]}, max_len=48)
    logits, c = model.prefill(params, {"tokens": _t(tokens[:, :40])}, max_len=48)
    assert c["k"].shape[2] == cfg.sliding_window == 32
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    if not kv_quantized:
        for n in ("k", "v"):
            np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)
    dec = jax.jit(jm.decode)
    for pos in range(40, 44):
        if kv_quantized:  # decode from JAX's int8 cache: fp32-close K/V may round apart
            c = {n: torch.from_numpy(np.array(t)) for n, t in jc.items()}
        jl, jc = dec(jparams, {"tokens": tokens[:, pos : pos + 1]}, jc, jnp.asarray(pos, jnp.int32))
        logits, c = model.decode(params, {"tokens": _t(tokens[:, pos : pos + 1])}, c, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)


@pytest.mark.parametrize("kv_quantized", [False, True])
def test_hymba_ring_and_ssm_state_through_the_wrap(kv_quantized):
    """hymba smoke, window 32: a 40-token prompt (past the window, no
    multiple of it; five SSM chunks of 8) lands rolled beside its SSM
    state, then four decode steps carry both; logits and every cache leaf
    against JAX's (an int8 run decodes each step from JAX's cache, as the
    mixtral twin above)."""
    jmodel, jparams, cfg, params, _ = _setup("hymba-1.5b")
    jm = jax_build_model(jmodel.cfg, _jax_opts(kv_quantized=kv_quantized))
    model = _model(cfg, kv_quantized=kv_quantized)
    tokens = np.random.default_rng(41).integers(0, cfg.vocab_size, (B, 44), dtype=np.int32)
    jl, jc = jm.prefill(jparams, {"tokens": tokens[:, :40]}, max_len=48)
    logits, c = model.prefill(params, {"tokens": _t(tokens[:, :40])}, max_len=48)
    assert c["k"].shape[2] == cfg.sliding_window == 32 and set(c) == set(jc)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
    for n in ("h", "conv") if kv_quantized else ("k", "v", "h", "conv"):
        np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)
    dec = jax.jit(jm.decode)
    for pos in range(40, 44):
        if kv_quantized:
            c = {n: torch.from_numpy(np.array(t)) for n, t in jc.items()}
        jl, jc = dec(jparams, {"tokens": tokens[:, pos : pos + 1]}, jc, jnp.asarray(pos, jnp.int32))
        logits, c = model.decode(params, {"tokens": _t(tokens[:, pos : pos + 1])}, c, pos)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **TOL)
        for n in ("h", "conv"):
            np.testing.assert_allclose(c[n].numpy(), np.asarray(jc[n]), **TOL)


def test_greedy_generate_from_frame_embeds_matches_jax():
    """musicgen: a prompt of frame embeddings (no tokens); the position
    count comes from them, as in the JAX loop. One token: the next
    decode step would feed a token back, which an audio model (no
    embedding table) does not take, in either package."""
    jmodel, jparams, cfg, params, _ = _setup("musicgen-medium")
    frames = steps(_inputs("musicgen-medium"), 0, 12)
    want = np.asarray(jax_greedy_generate(jmodel, jparams, frames, 1, 20))
    got = greedy_generate(_model(cfg), params, _torch(frames), 1, 20)
    assert got.dtype == torch.int32 and got.shape == (B, 1)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# int8 KV cache (twins of tests/test_kv_quant.py)
# ---------------------------------------------------------------------------


def test_quantize_roundtrip_bound():
    x = np.array(jax.random.normal(jax.random.PRNGKey(0), (2, 7, 3, 32)) * 5.0)
    q, s = attention.quantize_kv(torch.from_numpy(x))
    y = attention.dequantize_kv(q, s, torch.float32).numpy()
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    bound = amax / 127.0 * 0.5 + amax * 1.5e-3 + 1e-6
    assert np.all(np.abs(x - y) <= bound)
    # the same values and scales as the JAX quantizer on the same input
    jq, js = jax_attention.quantize_kv(x)
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


@pytest.mark.parametrize("name", ["qwen1.5-32b", "qwen2-72b", "mixtral-8x22b", "hymba-1.5b"])
def test_int8_decode_close_to_fp(name):
    """Token-by-token decode through an int8 cache lands within 5% of max
    |logit| of the full forward."""
    _, _, cfg, params, tokens = _setup(name)
    m_ref, m_q = _model(cfg), _model(cfg, kv_quantized=True)
    tok = _t(tokens[:, :S])
    logits_full, _ = m_ref.apply(params, {"tokens": tok})
    cache = m_q.init_cache(B, S, device=CPU)
    assert cache["k"].dtype == torch.int8
    for t in range(S):
        logits, cache = m_q.decode(params, {"tokens": tok[:, t : t + 1]}, cache, t)
    err = float((logits[:, 0] - logits_full[:, S - 1]).abs().max())
    base = float(logits_full.abs().max())
    assert err / base < 0.05, f"{name}: rel err {err / base:.4f}"


def test_int8_cache_halves_bytes():
    cfg = get_config("qwen1.5-32b").smoke()
    meta = torch.device("meta")
    c_bf = build_model(cfg).init_cache(4, 128, device=meta)
    c_q = build_model(cfg, ModelOptions(kv_quantized=True)).init_cache(4, 128, device=meta)
    size = lambda c: sum(t.numel() * t.element_size() for t in c.values())  # noqa: E731
    assert size(c_q) < size(c_bf) * 0.6  # int8 + fp16 scales ~ 0.56x of bf16


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen1.5-32b", "qwen3-moe-235b-a22b"])
def test_int8_prefill_cache_matches_jax(arch):
    """An int8 prefill's cache against JAX's from the same params and
    prompt. The port's quantizer on JAX's own fp32 K/V gives JAX's int8
    values and scales exactly. The port's K/V agree with JAX's to fp32
    rounding, so an int8 value may differ only where the value sits on a
    rounding tie (x / scale within 1e-4 of n + 1/2), and then by one."""
    jmodel, jparams, cfg, params, tokens = _setup(arch)
    jq = jax_build_model(jmodel.cfg, _jax_opts(kv_quantized=True))
    tok = tokens[:, :S]
    _, jc = jq.prefill(jparams, {"tokens": tok}, max_len=S + 4)
    _, jfloat = jmodel.prefill(jparams, {"tokens": tok}, max_len=S + 4)
    _, c = _model(cfg, kv_quantized=True).prefill(params, {"tokens": _t(tok)}, max_len=S + 4)
    assert set(c) == set(jc) == {"k", "v", "k_scale", "v_scale"}
    for n in ("k", "v"):
        vals, scale = attention.quantize_kv(torch.from_numpy(np.array(jfloat[n])))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jc[n]))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(jc[n + "_scale"]))
        assert c[n].dtype == torch.int8 and c[n + "_scale"].dtype == torch.float16
        np.testing.assert_allclose(_np(c[n + "_scale"]), np.asarray(jc[n + "_scale"], np.float32),
                                   rtol=1e-3, atol=0)  # fp16 rounding of fp32-close scales
        diff = c[n].numpy().astype(np.int32) - np.asarray(jc[n]).astype(np.int32)
        assert np.abs(diff).max() <= 1
        x = np.asarray(jfloat[n]) / np.maximum(
            np.abs(np.asarray(jfloat[n])).max(-1, keepdims=True) / 127.0, 1e-8)
        tie = np.abs(np.abs(x - np.floor(x)) - 0.5) < 1e-4
        assert not np.any((diff != 0) & ~tie)


# ---------------------------------------------------------------------------
# serve_step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b", "rwkv6-7b", "mixtral-8x22b",
                                  "hymba-1.5b"])
def test_greedy_generate_matches_jax(arch):
    """Greedy tokens from a 12-token prompt, 6 of them, fp32: identical to
    JAX's, int32, on the params' device."""
    jmodel, jparams, cfg, params, tokens = _setup(arch)
    prompt = tokens[:, :12]
    want = np.asarray(jax_greedy_generate(jmodel, jparams, {"tokens": prompt}, 6, 20))
    got = greedy_generate(_model(cfg), params, {"tokens": torch.from_numpy(prompt)}, 6, 20)
    assert got.dtype == torch.int32 and got.shape == (B, 6) and got.device == CPU
    np.testing.assert_array_equal(got.numpy(), want)


def test_serve_steps_are_the_model_methods():
    _, _, cfg, params, tokens = _setup("qwen3-8b")
    model = _model(cfg)
    batch = {"tokens": _t(tokens[:, :8])}
    logits, cache = make_prefill_step(model, max_len=12)(params, batch)
    want, want_cache = model.prefill(params, batch, max_len=12)
    assert torch.equal(logits, want) and torch.equal(cache["k"], want_cache["k"])
    step = make_decode_step(model)
    nxt = {"tokens": sample_token(logits, None, 0.0)[:, None]}
    got, _ = step(params, nxt, cache, 8)
    ref, _ = model.decode(params, nxt, want_cache, 8)
    assert torch.equal(got, ref)


def test_sample_token():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 1, 50)).astype(np.float32))
    greedy = sample_token(logits, None, 0.0)
    assert greedy.dtype == torch.int32 and torch.equal(greedy, logits.argmax(-1).int())
    draw = lambda seed, t=1.0: sample_token(  # noqa: E731
        logits, torch.Generator().manual_seed(seed), t)
    a = draw(0)
    assert a.shape == (4, 1) and a.dtype == torch.int32
    assert bool(((a >= 0) & (a < 50)).all())
    assert torch.equal(a, draw(0))  # repeatable under one seed
    many = torch.stack([draw(s, 1e-4) for s in range(5)])  # near-greedy
    assert torch.equal(many, greedy.expand_as(many))
    with pytest.raises(ValueError, match="Generator"):
        sample_token(logits, None, 1.0)


# ---------------------------------------------------------------------------
# runtime tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
def test_model_options_for_matches_jax(shape):
    """Every field the port's ``ModelOptions`` shares with JAX's, for
    each ported arch and its smoke config; serving shapes quantize the
    KV cache."""
    fields = {f.name for f in dataclasses.fields(ModelOptions)}
    shared = fields & {f.name for f in dataclasses.fields(JaxOptions)} - {"kernel_mode"}
    assert {"kv_quantized", "attn_q_chunk", "decode_cache_mode"} <= shared
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_config(arch).smoke(), jax_get_config(arch).smoke())):
            opts = runtime.model_options_for(cfg, SHAPES[shape])
            jopts = jax_runtime.model_options_for(jcfg, JAX_SHAPES[shape])
            for f in shared:
                assert getattr(opts, f) == getattr(jopts, f), (arch, f)
            assert opts.kv_quantized == (shape != "train_4k")
            assert opts.kernel_mode == "kernel"


def test_prefill_shape_model_emits_jax_int8_cache():
    """A model built from the prefill shape's options emits the int8 cache
    JAX's does (bf16 params and compute there)."""
    cfg = get_config("gemma-2b").smoke()
    opts = runtime.model_options_for(cfg, SHAPES["prefill_32k"])
    model = build_model(cfg, opts)
    params = model.init(torch.Generator().manual_seed(0))
    assert params["layers"]["attn"]["wq"].dtype == torch.bfloat16
    _, cache = model.prefill(params, {"tokens": torch.zeros((1, 6), dtype=torch.long)}, max_len=8)
    jcache = jax_build_model(jax_get_config("gemma-2b").smoke(), jax_runtime.model_options_for(
        jax_get_config("gemma-2b").smoke(), JAX_SHAPES["prefill_32k"])).init_cache(1, 8)
    for n, t in cache.items():
        assert tuple(t.shape) == jcache[n].shape and str(t.dtype)[6:] == str(jcache[n].dtype)
