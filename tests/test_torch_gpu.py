"""The port's CUDA kernels on the card (marker ``gpu``; they skip where no
CUDA device is present). Each kernel is held against its plain version on
the same CUDA tensors, its launch counter rises once a launch, and the
wrappers refuse what the kernels do not take. Run on a GPU machine with

    python -m pytest -q -m gpu --noconftest tests/test_torch_gpu.py

This file imports no JAX, and ``--noconftest`` skips the suite's JAX
conftest, so the GPU machine need not have JAX."""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops as rms_ops  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import ModelOptions, build_model  # noqa: E402

pytestmark = pytest.mark.gpu
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b, tol):
    torch.testing.assert_close(a.float(), b.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [
        (3, 5, 128),  # q/k-norm rows: several rows a block
        (7, 2048),
        (64, 4096),  # the serve path's norm
        (8192, 4096),
        (1, 100),  # not a multiple of the vector width: scalar loads
        (2, 20001),  # more than 16 vectors a thread: the looping form
    ],
)
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, shape, residual):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    scale = torch.randn(shape[-1], generator=gen, device=cuda).to(dtype)
    r = torch.randn(shape, generator=gen, device=cuda).to(dtype) if residual else None
    before = rms_ops.rmsnorm.launches
    out = rms_ops.rmsnorm(x, scale, r)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm.launches == before + 1
    assert out.dtype == dtype and out.shape == x.shape
    _close(out, rmsnorm_ref(x, scale, r), TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("residual", [False, True])
def test_rmsnorm_kernel_unaligned_view(cuda, dtype, residual):
    """A contiguous view one element off a 16-byte boundary takes the
    scalar loads of the same kernel."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(4 * 4096 + 1, generator=gen, device=cuda).to(dtype)[1:].view(4, 4096)
    assert x.data_ptr() % 16 != 0
    assert rms_ops.launch_shape(4096, x.element_size(), aligned=False).vec == 1
    scale = torch.randn(4096, generator=gen, device=cuda).to(dtype)
    r = torch.randn(4, 4096, generator=gen, device=cuda).to(dtype) if residual else None
    out = rms_ops.rmsnorm(x, scale, r)
    _close(out, rmsnorm_ref(x, scale, r), TOL[dtype])


def test_rmsnorm_wrapper_refuses(cuda):
    x = torch.randn(4, 64, device=cuda)
    with pytest.raises(TypeError):
        rms_ops.rmsnorm(x.half(), torch.ones(64, device=cuda).half())
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x.t(), torch.ones(4, device=cuda))
    with pytest.raises(ValueError):
        rms_ops.rmsnorm(x, torch.ones(32, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,window,q_offset",
    [
        (2, 128, 128, 4, 2, 64, None, 0),
        (1, 100, 100, 8, 1, 256, None, 0),   # ragged tile, gemma's head size
        (2, 256, 256, 4, 4, 32, 64, 0),      # sliding window
        (1, 64, 192, 4, 2, 128, None, 128),  # query suffix
        (1, 64, 64, 2, 1, 16, None, -16),    # fully-masked rows
    ],
)
def test_flash_kernel_matches_plain(cuda, dtype, b, sq, sk, hq, hkv, d, window, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, block_q=sq, block_k=sk, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    _close(out, attention_ref(q, k, v, **kw), TOL[dtype])


@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,d,causal,window,q_offset",
    [
        (2, 128, 128, 4, 4, 64, True, None, 0),  # GQA ratio 1
        (1, 1, 1, 8, 2, 128, True, None, 0),  # one query
        (2, 13, 13, 8, 1, 256, True, None, 0),  # 13 rows, ratio 8
        (4, 16, 16, 32, 8, 128, True, None, 0),  # serve prompt, qwen3-8b
        (4, 16, 16, 8, 1, 256, True, None, 0),  # serve prompt, gemma-2b
        (1, 100, 100, 8, 2, 64, True, None, 0),  # ragged last tiles
        (1, 100, 100, 8, 1, 256, True, None, 0),
        (1, 2048, 2048, 32, 8, 128, True, None, 0),  # prefill, qwen3-8b
        (1, 2048, 2048, 8, 1, 256, True, None, 0),  # prefill, gemma-2b
        (1, 256, 256, 8, 2, 128, True, 64, 0),  # sliding window
        (1, 300, 300, 4, 1, 256, True, 100, 0),
        (1, 64, 192, 8, 2, 128, True, None, 128),  # query suffix
        (1, 1, 512, 8, 1, 256, True, None, 511),  # one query at the end
        (1, 64, 64, 4, 1, 64, True, None, -16),  # fully-masked rows
        (1, 128, 100, 4, 4, 128, False, None, 0),  # bidirectional, ragged keys
    ],
)
def test_flash_wgmma_route_matches_plain(cuda, b, sq, sk, hq, hkv, d, causal, window, q_offset):
    """bf16 with d 64/128/256 takes the tensor-core kernel (TMA + wgmma)."""
    assert fa_ops.route(torch.bfloat16, d) == "wgmma"
    gen = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).bfloat16()
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).bfloat16()
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).bfloat16()
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, block_q=sq, block_k=sk, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    assert out.shape == (b, sq, hq, d) and out.dtype == torch.bfloat16 and out.is_contiguous()
    ref = attention_ref(q, k, v, **kw)
    _close(out, ref, TOL[torch.bfloat16])
    if q_offset < 0:
        assert (out[:, : -q_offset] == 0).all()


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_wgmma_reads_strided_views(cuda, d):
    """q/k/v as views of one projection, through TMA tensor maps of the
    views' own strides."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    qkv = torch.randn(2, 100, 3, 4, d, generator=gen, device=cuda).bfloat16()
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = fa_ops.flash_attention(q, k, v, block_q=100, block_k=100)
    _close(out, attention_ref(q, k, v), TOL[torch.bfloat16])


def test_flash_wgmma_refuses_misaligned_view(cuda):
    """TMA needs 16-byte strides and base: a 65-element head stride, or a
    base one element off, is refused, never sent to another route."""
    base = torch.zeros(64 * 2 * 65 + 8, device=cuda, dtype=torch.bfloat16)
    q = base.as_strided((1, 64, 2, 64), (64 * 2 * 65, 2 * 65, 65, 1))
    before = fa_ops.flash_attention.launches
    with pytest.raises(ValueError, match="head strides"):
        fa_ops.flash_attention(q, q, q, block_q=64, block_k=64)
    off = base[1:1 + 64 * 2 * 64].view(1, 64, 2, 64)
    with pytest.raises(ValueError, match="aligned base"):
        fa_ops.flash_attention(off, off, off, block_q=64, block_k=64)
    assert fa_ops.flash_attention.launches == before
    # the same views in fp32 take the SIMT kernel, which reads any stride
    q32 = torch.randn(64 * 2 * 65, device=cuda).as_strided((1, 64, 2, 64), (64 * 2 * 65, 2 * 65, 65, 1))
    _close(fa_ops.flash_attention(q32, q32, q32, block_q=64, block_k=64),
           attention_ref(q32, q32, q32), TOL[torch.float32])


def test_flash_reads_strided_views(cuda):
    """The model's q/k/v are views of wider projections: no copy needed."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    qkv = torch.randn(2, 64, 3, 4, 64, generator=gen, device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    out = fa_ops.flash_attention(q, k, v, block_q=64, block_k=64)
    _close(out, attention_ref(q, k, v), TOL[torch.float32])


def test_flash_wrapper_refuses(cuda):
    q = torch.randn(1, 64, 2, 48, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q, block_q=64, block_k=64)  # head size 48
    q = torch.randn(1, 100, 2, 64, device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q, block_q=64, block_k=64)  # ragged blocks
    with pytest.raises(TypeError):
        fa_ops.flash_attention(q.half(), q.half(), q.half(), block_q=100, block_k=100)


def test_serve_smoke_configs_through_the_kernels(cuda):
    from repro_torch.launch import serve

    rms0, fa0 = rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches
    wkv0 = wkv_ops.wkv6.launches
    report, ex = serve.serve(serve.build_parser().parse_args(
        ["--device", "cuda", "--smoke", "--requests", "2", "--rps", "4", "--duration", "1"]
    ))
    assert not report.failures
    assert len(ex.sessions) == 3
    served = sum(st.iterations_done for st in report.stats.values())
    assert served == sum(s.n_iters for s in ex.sessions.values()) > 0
    assert rms_ops.rmsnorm.launches > rms0 and fa_ops.flash_attention.launches > fa0
    assert wkv_ops.wkv6.launches > wkv0


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_smoke_prefill_kernel_matches_reference(cuda, arch):
    cfg = get_config(arch).smoke()
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = build_model(cfg).init(gen)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=cuda)}
    opts = dict(compute_dtype="float32")
    rms0, fa0 = rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches
    logits_k, cache_k = build_model(cfg, ModelOptions(kernel_mode="kernel", **opts)).prefill(params, batch)
    assert rms_ops.rmsnorm.launches - rms0 == cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    assert fa_ops.flash_attention.launches - fa0 == cfg.n_layers
    logits_r, cache_r = build_model(cfg, ModelOptions(kernel_mode="reference", **opts)).prefill(params, batch)
    _close(logits_k, logits_r, 1e-4)
    _close(cache_k["k"], cache_r["k"], 1e-4)
    _close(cache_k["v"], cache_r["v"], 1e-4)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

WKV_TOL = 2e-3  # the JAX kernel test's
# w = sigmoid(z) * span + low: the JAX test's slow and fast regimes, and a
# faster one with decays down to 0.05
REGIMES = {"slow": (0.1, 0.88), "fast": (0.5, 0.15), "faster": (0.9, 0.05)}


def _wkv_inputs(cuda, b, s, h, dk, dv, regime, seed=0):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    r = torch.randn(b, s, h, dk, generator=gen, device=cuda)
    k = torch.randn(b, s, h, dk, generator=gen, device=cuda)
    v = torch.randn(b, s, h, dv, generator=gen, device=cuda)
    span, low = REGIMES[regime]
    w = torch.sigmoid(torch.randn(b, s, h, dk, generator=gen, device=cuda)) * span + low
    u = torch.randn(h, dk, generator=gen, device=cuda) * 0.1
    return r, k, v, w, u


@pytest.mark.parametrize("regime", ["slow", "fast", "faster"])
@pytest.mark.parametrize(
    "b,s,h,dk,dv,chunk",
    [
        (2, 128, 3, 16, 16, 32),  # the JAX test's cases
        (1, 64, 2, 64, 64, 16),
        (2, 256, 4, 32, 32, 64),
        (1, 96, 1, 8, 8, 32),
        (3, 32, 2, 16, 16, 32),
        (4, 16, 64, 64, 64, 8),  # rwkv6-7b's serve prompt
        (1, 512, 8, 64, 64, 64),  # prefill-sized
    ],
)
def test_wkv6_kernel_matches_plain(cuda, b, s, h, dk, dv, chunk, regime):
    r, k, v, w, u = _wkv_inputs(cuda, b, s, h, dk, dv, regime)
    before = wkv_ops.wkv6.launches
    o, sf = wkv_ops.wkv6(r, k, v, w, u, chunk=chunk)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    assert o.shape == (b, s, h, dv) and sf.shape == (b, h, dk, dv)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    o_ref, s_ref = wkv6_ref(r, k, v, w, u)
    _close(o, o_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)


def test_wkv6_reads_strided_views(cuda):
    """The model's r/k/v/w are views of wider tensors: no copy needed."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    big = torch.randn(2, 64, 4, 3, 32, generator=gen, device=cuda)
    big[:, :, 3] = torch.sigmoid(big[:, :, 3]) * 0.5 + 0.15
    r, k, v, w = big.unbind(2)
    assert not w.is_contiguous() and w.stride(-1) == 1
    u = torch.randn(3, 32, generator=gen, device=cuda) * 0.1
    o, sf = wkv_ops.wkv6(r, k, v, w, u, chunk=16)
    o_ref, s_ref = wkv6_ref(r, k, v, w, u)
    _close(o, o_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)


def test_wkv6_reads_unaligned_views(cuda):
    """Views whose rows do not start 16-byte aligned (a base one element
    off, a head stride of 33) take the kernel's 4-byte copies."""
    gen = torch.Generator(device=cuda).manual_seed(10)
    flat = torch.randn(4 * 2 * 48 * 3 * 33 + 1, generator=gen, device=cuda)[1:]
    big = flat.view(2, 48, 4, 3, 33)[..., :32]
    big[:, :, 3] = torch.sigmoid(big[:, :, 3]) * 0.5 + 0.15
    r, k, v, w = big.unbind(2)
    assert r.data_ptr() % 16 != 0 and r.stride(2) == 33
    u = torch.randn(3, 32, generator=gen, device=cuda) * 0.1
    o, sf = wkv_ops.wkv6(r, k, v, w, u, chunk=16)
    o_ref, s_ref = wkv6_ref(r, k, v, w, u)
    _close(o, o_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)


def test_wkv6_wrapper_refuses(cuda):
    r, k, v, w, u = _wkv_inputs(cuda, 1, 64, 2, 16, 16, "slow")
    with pytest.raises(TypeError):
        wkv_ops.wkv6(r.bfloat16(), k, v, w, u)  # bf16
    r48, k48, _, w48, u48 = _wkv_inputs(cuda, 1, 64, 2, 48, 48, "slow")
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r48, k48, r48, w48, u48)  # head size 48
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r[:, :60], k[:, :60], v[:, :60], w[:, :60], u, chunk=16)  # ragged
    r2, k2, v2, w2, u2 = _wkv_inputs(cuda, 1, 128, 2, 16, 16, "slow")
    with pytest.raises(ValueError):
        wkv_ops.wkv6(r2, k2, v2, w2, u2, chunk=128)  # chunk above the kernel's 64
    strided = torch.randn(1, 64, 2, 32, device=cuda)[..., ::2]  # r's shape, last stride 2
    assert strided.shape == r.shape
    with pytest.raises(ValueError, match="last dimension must be contiguous"):
        wkv_ops.wkv6(strided, k, v, w, u)
    with pytest.raises(ValueError, match="s0 must be contiguous"):
        wkv_ops.wkv6(r, k, v, w, u, s0=torch.zeros(1, 2, 16, 16, device=cuda).mT)


@pytest.mark.parametrize("regime", ["slow", "faster"])
@pytest.mark.parametrize(
    "b,s,h,d,chunk",
    [
        (2, 100, 3, 64, 64),  # a last chunk of 36
        (4, 13, 64, 64, 8),  # rwkv6-7b's heads, a last chunk of 5
        (4, 1, 64, 64, 8),  # one token: a decode step
        (1, 70, 2, 16, 32),
    ],
)
def test_wkv6_kernel_ragged_from_a_state(cuda, b, s, h, d, chunk, regime):
    """A shorter last chunk, from a zero state and from a given one."""
    r, k, v, w, u = _wkv_inputs(cuda, b, s, h, d, d, regime, seed=s)
    s0 = torch.randn(b, h, d, d, generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    for start in (None, s0):
        before = wkv_ops.wkv6.launches
        o, sf = wkv_ops.wkv6(r, k, v, w, u, chunk=chunk, s0=start, ragged=True)
        torch.cuda.synchronize()
        assert wkv_ops.wkv6.launches == before + 1
        assert torch.isfinite(o).all() and torch.isfinite(sf).all()
        o_ref, s_ref = wkv6_ref(r, k, v, w, u, start)
        _close(o, o_ref, WKV_TOL)
        _close(sf, s_ref, WKV_TOL)


def _column_tile(tile, dv):
    return {"auto": 0, "head": dv, "half": dv // 2 if dv >= 16 else dv}[tile]


@pytest.mark.parametrize("tile", ["auto", "head", "half"])
@pytest.mark.parametrize(
    "b,s,h,dk,dv,chunk",
    [
        (2, 48, 3, 64, 64, 24),  # chunk 24: a sub-chunk and a half
        (3, 21, 4, 64, 64, 8),  # chunk 8, a last chunk of 5
        (1, 77, 2, 32, 32, 16),  # a last chunk of 13
        (2, 64, 2, 8, 8, 64),  # small heads: one k-step of 8 channels
        (2, 64, 2, 16, 16, 64),
        (2, 64, 2, 32, 32, 64),
        (1, 64, 2, 8, 64, 32),  # dk != dv
        (1, 64, 2, 64, 16, 32),
    ],
)
def test_wkv6_kernel_chunks_heads_and_tiles(cuda, b, s, h, dk, dv, chunk, tile):
    """Chunks that are not a multiple of the 16-row sub-chunk, every head
    size, and both column tilings (the whole head a block, or two blocks
    a head), from a given state."""
    r, k, v, w, u = _wkv_inputs(cuda, b, s, h, dk, dv, "fast", seed=s + dk)
    s0 = torch.randn(b, h, dk, dv, generator=torch.Generator(device=cuda).manual_seed(2),
                     device=cuda)
    before = wkv_ops.wkv6.launches
    o, sf = wkv_ops._wkv6(r, k, v, w, u, chunk, s0, True, _column_tile(tile, dv))
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    o_ref, s_ref = wkv6_ref(r, k, v, w, u, s0)
    _close(o, o_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)


@pytest.mark.parametrize("low", [0.0, 1e-30])
def test_wkv6_kernel_decay_underflow(cuda, low):
    """Decays that underflowed to 0, or below the e^-60 floor on log w, in
    half the channels: finite, and on the plain version."""
    r, k, v, w, u = _wkv_inputs(cuda, 2, 128, 4, 64, 64, "fast", seed=8)
    w[..., ::2] = low
    o, sf = wkv_ops.wkv6(r, k, v, w, u, chunk=64)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    o_ref, s_ref = wkv6_ref(r, k, v, w, u)
    _close(o, o_ref, WKV_TOL)
    _close(sf, s_ref, WKV_TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_wkv6_kernel_two_calls_chain_through_s0(cuda, chunk):
    """Two launches on one stream, the second from the first's state,
    equal one launch over the whole sequence (split at a chunk boundary,
    so both do the same arithmetic)."""
    r, k, v, w, u = _wkv_inputs(cuda, 2, 192, 4, 64, 64, "slow", seed=9)
    o, sf = wkv_ops.wkv6(r, k, v, w, u, chunk=chunk)
    cut = 128
    o1, s1 = wkv_ops.wkv6(r[:, :cut], k[:, :cut], v[:, :cut], w[:, :cut], u, chunk=chunk)
    o2, s2 = wkv_ops.wkv6(r[:, cut:], k[:, cut:], v[:, cut:], w[:, cut:], u, chunk=chunk, s0=s1)
    torch.cuda.synchronize()
    torch.testing.assert_close(torch.cat([o1, o2], 1), o, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(s2, sf, rtol=1e-6, atol=1e-6)


def test_rwkv_smoke_prefill_kernel_matches_reference(cuda):
    cfg = get_config("rwkv6-7b").smoke()
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = build_model(cfg).init(gen)
    params["layers"]["tmix"]["decay_base"] = torch.linspace(
        -4.6, 0.64, cfg.d_model, device=cuda
    ).expand(cfg.n_layers, -1).contiguous()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 16), generator=gen, device=cuda)}
    opts = dict(compute_dtype="float32", wkv_chunk=8)
    rms0, wkv0 = rms_ops.rmsnorm.launches, wkv_ops.wkv6.launches
    logits_k, cache_k = build_model(cfg, ModelOptions(kernel_mode="kernel", **opts)).prefill(params, batch)
    assert rms_ops.rmsnorm.launches - rms0 == 2 * cfg.n_layers + 1
    assert wkv_ops.wkv6.launches - wkv0 == cfg.n_layers
    logits_r, cache_r = build_model(cfg, ModelOptions(kernel_mode="reference", **opts)).prefill(params, batch)
    _close(logits_k, logits_r, 1e-4)
    for name in ("tmix_shift", "cmix_shift", "wkv"):
        _close(cache_k[name], cache_r[name], 1e-4)


@pytest.mark.parametrize("seq", [13, 1])
def test_rwkv_smoke_prefill_any_length_through_the_kernel(cuda, seq):
    """A prompt the chunk does not divide, and a single token, still go
    through the kernel, once a layer, and agree with the reference mode."""
    cfg = get_config("rwkv6-7b").smoke()
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = build_model(cfg).init(gen)
    params["layers"]["tmix"]["decay_base"] = torch.linspace(
        -4.6, 0.64, cfg.d_model, device=cuda
    ).expand(cfg.n_layers, -1).contiguous()
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, seq), generator=gen, device=cuda)}
    opts = dict(compute_dtype="float32", wkv_chunk=8)
    wkv0 = wkv_ops.wkv6.launches
    logits_k, cache_k = build_model(cfg, ModelOptions(kernel_mode="kernel", **opts)).prefill(params, batch)
    assert wkv_ops.wkv6.launches - wkv0 == cfg.n_layers
    logits_r, cache_r = build_model(cfg, ModelOptions(kernel_mode="reference", **opts)).prefill(params, batch)
    _close(logits_k, logits_r, 1e-4)
    for name in ("tmix_shift", "cmix_shift", "wkv"):
        _close(cache_k[name], cache_r[name], 1e-4)


# ---------------------------------------------------------------------------
# backward kernels (B1: RMSNorm, B2: flash attention) and autograd through
# the wrappers
# ---------------------------------------------------------------------------

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_lse_ref,
)
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_bwd_ref  # noqa: E402

BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}  # relative Frobenius


def _rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _noncontiguous(t):
    """The same values as a strided view (every other element of the last
    dimension of a buffer twice as wide)."""
    buf = torch.empty((*t.shape[:-1], 2 * t.shape[-1]), dtype=t.dtype, device=t.device)
    view = buf[..., ::2]
    view.copy_(t)
    assert not view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "shape",
    [(3, 5, 128), (4096, 2048), (7, 4096), (5, 16384), (2, 20001), (1, 100), (300, 64)],
)
def test_rmsnorm_bwd_kernel_matches_plain(cuda, dtype, shape):
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    scale = (torch.randn(shape[-1], generator=gen, device=cuda) * 0.1 + 1).to(dtype)
    g = _noncontiguous(torch.randn(shape, generator=gen, device=cuda).to(dtype))
    before = rms_ops.rmsnorm_bwd.launches
    dx, ds = rms_ops.rmsnorm_bwd(g, x, scale)
    torch.cuda.synchronize()
    assert rms_ops.rmsnorm_bwd.launches == before + 1
    rdx, rds = rmsnorm_bwd_ref(g, x, scale)
    assert dx.dtype == dtype and ds.dtype == dtype
    assert _rel(dx, rdx) <= BWD_TOL[dtype] and _rel(ds, rds) <= BWD_TOL[dtype]
    # through autograd: the Function's backward is the kernel
    xa, sa = x.clone().requires_grad_(), scale.clone().requires_grad_()
    before = rms_ops.rmsnorm_bwd.launches
    rms_ops.rmsnorm(xa, sa).backward(g)
    assert rms_ops.rmsnorm_bwd.launches == before + 1
    xb, sb = x.clone().requires_grad_(), scale.clone().requires_grad_()
    rmsnorm_ref(xb, sb).backward(g)
    assert _rel(xa.grad, xb.grad) <= BWD_TOL[dtype] and _rel(sa.grad, sb.grad) <= BWD_TOL[dtype]


def test_rmsnorm_residual_form_refuses_autograd(cuda):
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="residual"):
        rms_ops.rmsnorm(x, torch.ones(64, device=cuda), torch.randn(4, 64, device=cuda))
    with torch.no_grad():
        rms_ops.rmsnorm(x, torch.ones(64, device=cuda), torch.randn(4, 64, device=cuda))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,window,q_offset",
    [
        (2, 128, 128, 4, 2, None, 0),
        (1, 100, 100, 8, 1, None, 0),  # ragged tiles, GQA 8
        (1, 130, 130, 4, 4, 40, 0),  # sliding window
        (1, 64, 192, 4, 2, None, 128),  # query suffix
        (1, 64, 64, 2, 1, None, -16),  # fully-masked rows
    ],
)
def test_flash_bwd_kernel_matches_plain(cuda, dtype, d, b, sq, sk, hq, hkv, window, q_offset):
    gen = torch.Generator(device=cuda).manual_seed(d + sq)
    q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    g = _noncontiguous(torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    out, lse = fa_ops._forward(q, k, v, True, window, q_offset, want_lse=True)
    ro, rl = attention_lse_ref(q, k, v, **kw)
    assert torch.equal(torch.isinf(lse), torch.isinf(rl))
    torch.testing.assert_close(lse.nan_to_num(neginf=0), rl.nan_to_num(neginf=0), rtol=1e-5, atol=1e-5)
    before = fa_ops.flash_attention_bwd.launches
    got = fa_ops.flash_attention_bwd(g, q, k, v, out, lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches == before + 1
    want = attention_bwd_ref(g, q, k, v, out, lse, **kw)
    for a, w in zip(got, want):
        assert a.dtype == dtype and torch.isfinite(a.float()).all()
        assert _rel(a, w) <= BWD_TOL[dtype]
    if q_offset < 0:  # no valid key: zero gradient
        assert (got[0][:, : -q_offset] == 0).all()
    # through autograd against autograd of the plain forward
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    fa_ops.flash_attention(qa, ka, va, block_q=sq, block_k=sk, **kw).backward(g)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    attention_ref(qb, kb, vb, **kw).backward(g)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for a, w in ((qa.grad, qb.grad), (ka.grad, kb.grad), (va.grad, vb.grad)):
        assert _rel(a, w) <= tol


def _bwd_inputs(cuda, b, sq, sk, hq, hkv, d, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=gen, device=cuda).to(dtype)
    g = torch.randn(b, sq, hq, d, generator=gen, device=cuda).to(dtype)
    return q, k, v, g


def _check_wgmma_bwd(q, k, v, g, *, causal=True, window=None, q_offset=0):
    """The tensor-core backward against ``attention_bwd_ref`` and against
    autograd of ``attention_ref``, 2e-2 relative Frobenius each; returns
    the kernel's gradients."""
    sq, sk = q.shape[1], k.shape[1]
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = fa_ops._forward(q, k, v, causal, window, q_offset, want_lse=True)
    before = fa_ops.flash_attention_bwd.launches
    got = fa_ops.flash_attention_bwd(g, q, k, v, out, lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches == before + 1
    want = attention_bwd_ref(g, q, k, v, out, lse, **kw)
    qb, kb, vb = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attention_ref(qb, kb, vb, **kw).backward(g)
    for a, w, w2 in zip(got, want, (qb.grad, kb.grad, vb.grad)):
        assert a.dtype == torch.bfloat16 and a.is_contiguous() and torch.isfinite(a.float()).all()
        assert _rel(a, w) <= 2e-2 and _rel(a, w2) <= 2e-2
    if q_offset < 0:  # no valid key: zero gradient
        assert (got[0][:, : -q_offset] == 0).all()
    # through autograd: the Function's backward is the same kernel
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa_ops.flash_attention(qa, ka, va, block_q=sq, block_k=sk, **kw).backward(g)
    for a, w in zip((qa.grad, ka.grad, va.grad), got):
        assert torch.equal(a, w)
    return got


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,window,q_offset",
    [
        (2, 128, 128, 4, 4, None, 0),  # GQA 1
        (1, 100, 100, 8, 2, None, 0),  # GQA 4, ragged last tiles
        (1, 13, 13, 8, 1, None, 0),  # GQA 8, 13 rows
        (1, 1, 512, 8, 1, None, 511),  # one query, at the end of 512 keys
        (1, 300, 300, 4, 1, 100, 0),  # sliding window
        (1, 64, 192, 8, 2, None, 128),  # query suffix
        (1, 64, 64, 4, 1, None, -16),  # fully-masked rows
    ],
)
def test_flash_bwd_wgmma_route_matches_plain(cuda, d, b, sq, sk, hq, hkv, window, q_offset):
    """bf16 with d 64/128/256 takes the tensor-core backward (wgmma +
    TMA), split over the GQA group's query heads where the plan says so."""
    assert fa_ops.route(torch.bfloat16, d) == "wgmma"
    q, k, v, g = _bwd_inputs(cuda, b, sq, sk, hq, hkv, d, seed=d + sq + hq)
    _check_wgmma_bwd(q, k, v, g, window=window, q_offset=q_offset)


@pytest.mark.parametrize("d", [64, 256])
def test_flash_bwd_wgmma_bidirectional(cuda, d):
    """No causal mask: one key tile a block, ragged keys."""
    q, k, v, g = _bwd_inputs(cuda, 1, 128, 100, 4, 2, d, seed=9)
    _check_wgmma_bwd(q, k, v, g, causal=False)


@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 256), (32, 8, 128)])
def test_flash_bwd_wgmma_training_shapes_repeat_bit_for_bit(cuda, hq, hkv, d):
    """(1, 4096) with gemma-2b's and qwen3-8b's heads: within tolerance of
    both references, and two calls give the same bits (no atomics)."""
    q, k, v, g = _bwd_inputs(cuda, 1, 4096, 4096, hq, hkv, d, seed=11)
    got = _check_wgmma_bwd(q, k, v, g)
    out, lse = fa_ops._forward(q, k, v, True, None, 0, want_lse=True)
    again = fa_ops.flash_attention_bwd(g, q, k, v, out, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_wgmma_strided_views(cuda, d):
    """q/k/v as views of one projection and a strided dO: the wrapper's
    contiguous copies go to the tensor maps."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn(2, 100, 3, 4, d, generator=gen, device=cuda).bfloat16()
    q, k, v = qkv.unbind(2)
    g = _noncontiguous(torch.randn(2, 100, 4, d, generator=gen, device=cuda).bfloat16())
    assert not q.is_contiguous() and not g.is_contiguous()
    _check_wgmma_bwd(q, k, v, g)


def _check_tf32_bwd(q, k, v, g, *, causal=True, window=None, q_offset=0):
    """The fp32 tensor-core backward (3xTF32) against ``attention_bwd_ref``
    and against autograd of ``attention_ref``, 1e-5 relative Frobenius
    each; through autograd bit-identical; returns the kernel's gradients."""
    sq, sk, d = q.shape[1], k.shape[1], q.shape[-1]
    assert fa_ops.bwd_route(torch.float32, d) == "mma_tf32"
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = fa_ops._forward(q, k, v, causal, window, q_offset, want_lse=True)
    before = fa_ops.flash_attention_bwd.launches
    got = fa_ops.flash_attention_bwd(g, q, k, v, out, lse, **kw)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention_bwd.launches == before + 1
    want = attention_bwd_ref(g, q, k, v, out, lse, **kw)
    qb, kb, vb = (t.detach().clone().requires_grad_() for t in (q, k, v))
    attention_ref(qb, kb, vb, **kw).backward(g)
    for a, w, w2 in zip(got, want, (qb.grad, kb.grad, vb.grad)):
        assert a.dtype == torch.float32 and a.is_contiguous() and torch.isfinite(a).all()
        assert _rel(a, w) <= 1e-5 and _rel(a, w2) <= 1e-5
    if q_offset < 0:  # no valid key: zero gradient
        assert (got[0][:, : -q_offset] == 0).all()
    qa, ka, va = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fa_ops.flash_attention(qa, ka, va, block_q=sq, block_k=sk, **kw).backward(g)
    for a, w in zip((qa.grad, ka.grad, va.grad), got):
        assert torch.equal(a, w)
    return got


@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize(
    "b,sq,sk,hq,hkv,window,q_offset",
    [
        (2, 128, 128, 4, 4, None, 0),  # GQA 1
        (1, 100, 100, 8, 2, None, 0),  # GQA 4, ragged last tiles
        (1, 13, 13, 8, 1, None, 0),  # GQA 8, 13 rows
        (1, 1, 512, 8, 1, None, 511),  # one query, at the end of 512 keys
        (1, 300, 300, 4, 1, 100, 0),  # sliding window
        (1, 64, 200, 8, 2, None, 136),  # query suffix, ragged keys
        (1, 64, 64, 4, 1, None, -16),  # fully-masked rows
    ],
)
def test_flash_bwd_tf32_route_matches_plain(cuda, d, b, sq, sk, hq, hkv, window, q_offset):
    """fp32 with d 64/128/256 takes the 3xTF32 tensor-core backward, split
    over the GQA group's query heads where the plan says so."""
    q, k, v, g = _bwd_inputs(cuda, b, sq, sk, hq, hkv, d, seed=d + sq + hq, dtype=torch.float32)
    _check_tf32_bwd(q, k, v, g, window=window, q_offset=q_offset)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_tf32_bidirectional(cuda, d):
    """No causal mask: one key tile a block, ragged keys."""
    q, k, v, g = _bwd_inputs(cuda, 1, 128, 100, 4, 2, d, seed=9, dtype=torch.float32)
    _check_tf32_bwd(q, k, v, g, causal=False)


@pytest.mark.parametrize("hq,hkv,d", [(8, 1, 256), (32, 8, 128)])
def test_flash_bwd_tf32_training_shapes_repeat_bit_for_bit(cuda, hq, hkv, d):
    """(1, 4096) with gemma-2b's and qwen3-8b's heads in fp32: within 1e-5
    of both references, and two calls give the same bits (no atomics)."""
    q, k, v, g = _bwd_inputs(cuda, 1, 4096, 4096, hq, hkv, d, seed=11, dtype=torch.float32)
    got = _check_tf32_bwd(q, k, v, g)
    out, lse = fa_ops._forward(q, k, v, True, None, 0, want_lse=True)
    again = fa_ops.flash_attention_bwd(g, q, k, v, out, lse)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("d", [64, 128, 256])
def test_flash_bwd_tf32_strided_views(cuda, d):
    """q/k/v as views of one projection and a strided dO, in fp32."""
    gen = torch.Generator(device=cuda).manual_seed(12)
    qkv = torch.randn(2, 100, 3, 4, d, generator=gen, device=cuda)
    q, k, v = qkv.unbind(2)
    g = _noncontiguous(torch.randn(2, 100, 4, d, generator=gen, device=cuda))
    assert not q.is_contiguous() and not g.is_contiguous()
    _check_tf32_bwd(q, k, v, g)


@pytest.mark.parametrize(
    "rows,d,dtype",
    [
        (4096, 2048, torch.bfloat16),  # chip_smoke's three shapes
        (131072, 128, torch.bfloat16),
        (8192, 4096, torch.float32),
        (4095, 2048, torch.bfloat16),  # ragged: a last row group with dead slots
        (131071, 128, torch.bfloat16),
        (8191, 4096, torch.float32),
        (37, 20001, torch.float32),  # the looping form
        (1000, 2048, torch.float32),
    ],
)
def test_rmsnorm_bwd_redesign_matches_plain_and_repeats(cuda, rows, d, dtype):
    """The backward kernel at the training path's shapes and beside them:
    within 1e-5 (fp32) / 2e-2 (bf16) relative Frobenius of the plain
    version and of autograd, and two calls give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
    scale = (torch.randn(d, generator=gen, device=cuda) * 0.1 + 1).to(dtype)
    g = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
    dx, ds = rms_ops.rmsnorm_bwd(g, x, scale)
    dx2, ds2 = rms_ops.rmsnorm_bwd(g, x, scale)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    rdx, rds = rmsnorm_bwd_ref(g, x, scale)
    xa, sa = x.clone().requires_grad_(), scale.clone().requires_grad_()
    rmsnorm_ref(xa, sa).backward(g)
    tol = BWD_TOL[dtype]
    for a, w in ((dx, rdx), (ds, rds), (dx, xa.grad), (ds, sa.grad)):
        assert torch.isfinite(a.float()).all() and _rel(a, w) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(4096, 2048), (513, 128), (3, 20001)])
def test_rmsnorm_bwd_unaligned_views_repeat(cuda, dtype, rows, d):
    """x one element off 16 bytes: the scalar-load path (no ring), or the
    loop; same tolerance, same bits twice."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    buf = torch.randn(rows * d + 1, generator=gen, device=cuda).to(dtype)
    x = buf[1:].view(rows, d)
    assert x.data_ptr() % 16
    scale = (torch.randn(d, generator=gen, device=cuda) * 0.1 + 1).to(dtype)
    g = torch.randn(rows, d, generator=gen, device=cuda).to(dtype)
    assert rms_ops.bwd_launch_shape(d, x.element_size(), False).vec == 1
    dx, ds = rms_ops.rmsnorm_bwd(g, x, scale)
    dx2, ds2 = rms_ops.rmsnorm_bwd(g, x, scale)
    torch.cuda.synchronize()
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)
    rdx, rds = rmsnorm_bwd_ref(g, x, scale)
    assert _rel(dx, rdx) <= BWD_TOL[dtype] and _rel(ds, rds) <= BWD_TOL[dtype]


def test_smoke_model_grads_wgmma_route_bf16(cuda):
    """gemma-2b smoke with heads of 256 in bf16: the attention backward
    takes the tensor-core route, and every gradient leaf through the
    kernels is within 2e-2 relative Frobenius of the plain path's."""
    from dataclasses import replace

    from repro_torch.train.train_step import stack_grads, value_and_grad

    cfg = replace(get_config("gemma-2b").smoke(), head_dim=256)
    assert fa_ops.route(torch.bfloat16, cfg.head_dim) == "wgmma"
    gen = torch.Generator(device=cuda).manual_seed(1)
    params = build_model(cfg).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 128), generator=gen, device=cuda)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=-1)}
    grads = {}
    for mode in ("kernel", "reference"):
        model = build_model(cfg, ModelOptions(kernel_mode=mode, compute_dtype="bfloat16",
                                              loss_chunk=32))
        before = fa_ops.flash_attention_bwd.launches
        loss, g = value_and_grad(model, params, batch)
        grads[mode] = (float(loss), stack_grads(g))
        launched = fa_ops.flash_attention_bwd.launches - before
        assert launched == (cfg.n_layers if mode == "kernel" else 0)
    (lk, gk), (lr_, gr) = grads["kernel"], grads["reference"]
    assert lk == pytest.approx(lr_, rel=1e-2)
    for a, b in zip(torch.utils._pytree.tree_leaves(gk), torch.utils._pytree.tree_leaves(gr)):
        assert torch.isfinite(a).all() and b.norm() > 0
        assert _rel(a, b) <= 2e-2


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen3-8b"])
def test_smoke_model_grads_kernel_match_reference(cuda, arch):
    """Every gradient leaf of a smoke model through the kernels equals the
    plain path's (fp32): the CUDA wrappers carry gradients to the weights
    upstream of a norm or of attention (wq, wk, wv, the norm scales)."""
    from repro_torch.train.train_step import stack_grads, value_and_grad

    cfg = get_config(arch).smoke()
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = build_model(cfg).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen, device=cuda)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=-1)}
    grads = {}
    for mode in ("kernel", "reference"):
        model = build_model(cfg, ModelOptions(kernel_mode=mode, compute_dtype="float32", loss_chunk=16))
        before = (rms_ops.rmsnorm_bwd.launches, fa_ops.flash_attention_bwd.launches)
        loss, g = value_and_grad(model, params, batch)
        grads[mode] = (float(loss), stack_grads(g))
        launched = (rms_ops.rmsnorm_bwd.launches - before[0],
                    fa_ops.flash_attention_bwd.launches - before[1])
        norms = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
        assert launched == ((norms, cfg.n_layers) if mode == "kernel" else (0, 0))
    (lk, gk), (lr_, gr) = grads["kernel"], grads["reference"]
    assert lk == pytest.approx(lr_, rel=1e-5)
    for a, b in zip(torch.utils._pytree.tree_leaves(gk), torch.utils._pytree.tree_leaves(gr)):
        assert b.norm() > 0
        assert _rel(a, b) <= 1e-4


def test_wkv6_refuses_autograd(cuda):
    r = torch.randn(1, 16, 2, 16, device=cuda, requires_grad=True)
    w = torch.rand(1, 16, 2, 16, device=cuda) * 0.5 + 0.4
    u = torch.zeros(2, 16, device=cuda)
    before = wkv_ops.wkv6.launches
    with pytest.raises(NotImplementedError, match="backward"):
        wkv_ops.wkv6(r, r, r, w, u)
    assert wkv_ops.wkv6.launches == before
    with torch.no_grad():
        wkv_ops.wkv6(r, r, r, w, u)
    assert wkv_ops.wkv6.launches == before + 1


# ---------------------------------------------------------------------------
# decode: K3 at one query against a cache view, K4 from a carried state,
# and a full-width decode step through the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("hq,hkv,d", [(32, 8, 128), (8, 1, 256), (4, 2, 64)])
@pytest.mark.parametrize("sk", [1, 33, 4097])
def test_flash_decode_on_cache_views(cuda, sk, hq, hkv, d, folded, dtype):
    """One query a sequence against the valid prefix of layer 1 of a
    stacked cache (a strided view, not contiguous), non-causal, as
    ``attention_decode`` calls it; ``folded``: the GQA group's query heads
    as query rows of their kv head (every row has the same keys).

    Outputs average V over ~sk/e keys, so they shrink as ~sqrt(e/sk)
    (0.026 at 4097 keys) and bf16's elementwise 2e-2 floor alone would
    pass a dropped key tile. So bf16 is also held by relative Frobenius
    within 2^-7 (both sides round P and the output to bf16: ~3e-3 apart),
    and a control that must miss that bound: the kernel without its last
    keys (64, or half of a short prefix)."""
    b, cap, n_rep = 3, 4097 + 64, hq // hkv
    gen = torch.Generator(device=cuda).manual_seed(sk + d)
    cache = torch.randn(2, 2, b, cap, hkv, d, generator=gen, device=cuda).to(dtype)
    k, v = cache[0, 1, :, :sk], cache[1, 1, :, :sk]
    assert not k.is_contiguous() or sk == cap
    q = torch.randn(b, 1, hq, d, generator=gen, device=cuda).to(dtype)
    ref = attention_ref(q, k, v, causal=False)

    def run(n):
        if folded:
            qf = q.view(b, hkv, n_rep, d).transpose(1, 2)
            out = fa_ops.flash_attention(qf, k[:, :n], v[:, :n], causal=False,
                                         block_q=n_rep, block_k=n)
            return out.transpose(1, 2).reshape(b, 1, hq, d)
        return fa_ops.flash_attention(q, k[:, :n], v[:, :n], causal=False, block_q=1, block_k=n)

    before = fa_ops.flash_attention.launches
    out = run(sk)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    _close(out, ref, TOL[dtype])
    if dtype == torch.bfloat16:
        assert _rel(out, ref) <= 2.0 ** -7
    if sk > 1:
        assert _rel(run(sk - min(64, sk // 2)), ref) > 2.0 ** -7


@pytest.mark.parametrize("regime", ["slow", "faster"])
def test_wkv6_decode_step_from_a_state(cuda, regime):
    """rwkv6-7b's decode step: one token, 64 heads of 64, batch 128, from
    a carried state."""
    b, h, d = 128, 64, 64
    r, k, v, w, u = _wkv_inputs(cuda, b, 1, h, d, d, regime, seed=8)
    s0 = torch.randn(b, h, d, d, generator=torch.Generator(device=cuda).manual_seed(9),
                     device=cuda)
    before = wkv_ops.wkv6.launches
    o, s = wkv_ops.wkv6(r, k, v, w, u, chunk=64, s0=s0)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    o_ref, s_ref = wkv6_ref(r, k, v, w, u, s0)
    torch.testing.assert_close(o, o_ref, rtol=WKV_TOL, atol=WKV_TOL)
    torch.testing.assert_close(s, s_ref, rtol=WKV_TOL, atol=WKV_TOL)


@pytest.mark.parametrize("arch,kv_quantized", [
    ("gemma-2b", False), ("gemma-2b", True), ("qwen3-8b", False), ("qwen3-8b", True),
    ("rwkv6-7b", False)])
def test_full_width_decode_step_kernel_matches_plain(cuda, arch, kv_quantized):
    """Full width, depth cut to 2, fp32: a (2, 40) prefill into a cache of
    48 slots, then two decode steps through the kernels against the plain
    path: logits and the new cache at 1e-4, and the launches a step (an
    int8 cache takes the plain attention). Unquantized, each path prefills
    its own cache. With an int8 cache the two paths' K/V agree only to
    fp32 rounding, so a value on a rounding tie may quantize one apart; so
    the kernel run decodes each step from a copy of the plain run's cache
    (the plain prefill's first), and the slot a step writes may differ by
    at most one in under 0.1% of its values."""
    import dataclasses

    cfg = dataclasses.replace(get_config(arch), n_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(10)
    params = build_model(cfg).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 42), generator=gen, device=cuda)
    modes = ("kernel", "reference")
    models = {mode: build_model(cfg, ModelOptions(kernel_mode=mode, compute_dtype="float32",
                                                  kv_quantized=kv_quantized))
              for mode in modes}
    caches = {mode: models[mode].prefill(params, {"tokens": tokens[:, :40]}, max_len=48)[1]
              for mode in modes}
    logits = {mode: [] for mode in modes}
    launched = {mode: (0, 0, 0) for mode in modes}
    for pos in (40, 41):
        if kv_quantized:
            caches["kernel"] = {n: t.clone() for n, t in caches["reference"].items()}
        for mode in modes:
            counts = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches,
                      wkv_ops.wkv6.launches)
            step, caches[mode] = models[mode].decode(
                params, {"tokens": tokens[:, pos : pos + 1]}, caches[mode], pos)
            torch.cuda.synchronize()
            launched[mode] = tuple(n + a - b for n, a, b in zip(launched[mode], (
                rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches,
                wkv_ops.wkv6.launches), counts))
            logits[mode].append(step)
        for name, t in caches["kernel"].items():
            if t.dtype == torch.int8:
                diff = t[:, :, pos].int() - caches["reference"][name][:, :, pos].int()
                assert diff.abs().max().item() <= 1
                assert (diff != 0).float().mean().item() < 1e-3
    if cfg.family == "ssm":
        norms = 2 * cfg.n_layers + 1
    else:
        norms = cfg.n_layers * (4 if cfg.qk_norm else 2) + 1
    attn = 0 if cfg.family == "ssm" or kv_quantized else cfg.n_layers
    wkv = cfg.n_layers if cfg.family == "ssm" else 0
    assert launched["kernel"] == (2 * norms, 2 * attn, 2 * wkv)
    assert launched["reference"] == (0, 0, 0)
    _close(torch.stack(logits["kernel"]), torch.stack(logits["reference"]), 1e-4)
    for name, t in caches["kernel"].items():
        ref = caches["reference"][name]
        if t.dtype == torch.int8:
            diff = t.int() - ref.int()
            assert diff.abs().max().item() <= 1 and (diff != 0).float().mean().item() < 1e-3
        else:
            _close(t, ref, 1e-4)


def test_mixtral_smoke_prefill_and_ring_decode_kernel_matches_plain(cuda):
    """mixtral smoke (MoE, window 32) on the card, fp32: a (2, 40) prompt
    (the window binds: 40 > 32, and the ring is rolled by 40 % 32), then
    six decode steps, so the ring's next slots are overwritten, through
    the kernels against the plain path: logits and caches at 1e-4, the
    same dropped assignments, and the launches a prefill and a step."""
    from chip_smoke import dropped as count_dropped
    from chip_smoke import moe_trace

    cfg = get_config("mixtral-8x22b").smoke()
    gen = torch.Generator(device=cuda).manual_seed(19)
    params = build_model(cfg).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 46), generator=gen, device=cuda)
    modes = ("kernel", "reference")
    models = {m: build_model(cfg, ModelOptions(kernel_mode=m, compute_dtype="float32", moe_group=16))
              for m in modes}
    out, launched, dropped = {}, {}, {}
    for mode in modes:
        counts = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches)
        with moe_trace() as log:
            logits, cache = models[mode].prefill(params, {"tokens": tokens[:, :40]}, max_len=64)
            steps = [logits]
            for pos in range(40, 46):
                step, cache = models[mode].decode(
                    params, {"tokens": tokens[:, pos : pos + 1]}, cache, pos)
                steps.append(step[:, 0])
        torch.cuda.synchronize()
        launched[mode] = (rms_ops.rmsnorm.launches - counts[0],
                          fa_ops.flash_attention.launches - counts[1])
        out[mode] = (torch.stack(steps), cache)
        dropped[mode] = count_dropped(log)
    assert out["kernel"][1]["k"].shape[2] == cfg.sliding_window == 32
    assert launched["kernel"] == (7 * (2 * cfg.n_layers + 1), 7 * cfg.n_layers)
    assert launched["reference"] == (0, 0)
    assert dropped["kernel"] == dropped["reference"]
    _close(out["kernel"][0], out["reference"][0], 1e-4)
    for name in ("k", "v"):
        _close(out["kernel"][1][name], out["reference"][1][name], 1e-4)


# ---------------------------------------------------------------------------
# the last three families: hymba (window + SSM state), qwen2-vl (patches,
# M-RoPE), and K3 at hymba's GQA group of five
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sk", [1, 5, 33, 1024, 4097])
def test_flash_decode_folded_five_query_heads_a_kv_head(cuda, sk):
    """hymba's decode attention: 25 query heads over 5 kv heads of 64,
    bf16, folded as ``attention.attend_prefix_folded`` does, so that each
    kv head takes 5 query rows (an odd count in a 64-row tile) through a
    strided view whose head stride is 640 bytes; against the plain
    version, elementwise and by relative Frobenius, with a control
    without the last keys that must miss the bound."""
    from repro_torch.models.attention import attend_prefix_folded

    b, hq, hkv, d, cap = 4, 25, 5, 64, 4097 + 64
    gen = torch.Generator(device=cuda).manual_seed(sk)
    cache = torch.randn(2, b, cap, hkv, d, generator=gen, device=cuda).bfloat16()
    k, v = cache[0, :, :sk], cache[1, :, :sk]
    q = torch.randn(b, 1, hq, d, generator=gen, device=cuda).bfloat16()
    rows = q.reshape(b, hkv, hq // hkv, d).transpose(1, 2)
    assert rows.stride()[2] * rows.element_size() == 640
    before = fa_ops.flash_attention.launches
    out = attend_prefix_folded(q, k, v)
    torch.cuda.synchronize()
    assert fa_ops.flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=False)
    _close(out, ref, TOL[torch.bfloat16])
    assert _rel(out, ref) <= 2.0 ** -7
    if sk > 1:
        n = sk - min(64, (sk + 1) // 2)
        assert _rel(attend_prefix_folded(q, k[:, :n], v[:, :n]), ref) > 2.0 ** -7


def test_hymba_smoke_prefill_past_its_window_and_ring_decode_kernel_matches_plain(cuda):
    """hymba smoke (window 32, SSM chunks of 8), fp32: a (2, 40) prompt
    (the window binds, the ring is rolled by 40 % 32, and five SSM
    chunks run), then six decode steps that carry the ring and the SSM
    state, through the kernels against the plain path: logits and every
    cache leaf at 1e-4, and the launches (the SSM branch launches none)."""
    cfg = get_config("hymba-1.5b").smoke()
    gen = torch.Generator(device=cuda).manual_seed(20)
    params = build_model(cfg).init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (2, 46), generator=gen, device=cuda)
    out, launched = {}, {}
    for mode in ("kernel", "reference"):
        model = build_model(cfg, ModelOptions(kernel_mode=mode, compute_dtype="float32",
                                              ssm_chunk=8))
        counts = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches)
        logits, cache = model.prefill(params, {"tokens": tokens[:, :40]}, max_len=64)
        steps = [logits]
        for pos in range(40, 46):
            step, cache = model.decode(params, {"tokens": tokens[:, pos : pos + 1]}, cache, pos)
            steps.append(step[:, 0])
        torch.cuda.synchronize()
        launched[mode] = (rms_ops.rmsnorm.launches - counts[0],
                          fa_ops.flash_attention.launches - counts[1])
        out[mode] = (torch.stack(steps), cache)
    assert out["kernel"][1]["k"].shape[2] == cfg.sliding_window == 32
    assert set(out["kernel"][1]) == {"k", "v", "h", "conv"}
    assert launched["kernel"] == (7 * (2 * cfg.n_layers + 1), 7 * cfg.n_layers)
    assert launched["reference"] == (0, 0)
    _close(out["kernel"][0], out["reference"][0], 1e-4)
    for name, t in out["kernel"][1].items():
        _close(t, out["reference"][1][name], 1e-4)


def test_qwen2_vl_smoke_prefill_with_spliced_patches_kernel_matches_plain(cuda):
    """qwen2-vl smoke, fp32: a (2, 24) prompt whose first four embeddings
    are patch embeddings, on distinct grid M-RoPE ids, through the kernels
    against the plain path (logits and K/V at 1e-4); the patches move the
    logits, and so do the grid ids against plain RoPE-like ids."""
    cfg = get_config("qwen2-vl-72b").smoke()
    gen = torch.Generator(device=cuda).manual_seed(21)
    params = build_model(cfg).init(gen)
    b, s, n = 2, 24, cfg.n_frontend_tokens
    grid = torch.tensor([[0, i // 2, i % 2] for i in range(n)], device=cuda).T
    text = (grid.max() + 1 + torch.arange(s - n, device=cuda)).expand(3, -1)
    batch = {
        "tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=cuda),
        "patch_embeds": torch.randn(b, n, cfg.d_model, generator=gen, device=cuda),
        "positions": torch.cat([grid, text], dim=1).expand(b, 3, s).int(),
    }
    models = {mode: build_model(cfg, ModelOptions(kernel_mode=mode, compute_dtype="float32"))
              for mode in ("kernel", "reference")}
    counts = (rms_ops.rmsnorm.launches, fa_ops.flash_attention.launches)
    logits, cache = models["kernel"].prefill(params, batch)
    torch.cuda.synchronize()
    assert (rms_ops.rmsnorm.launches - counts[0], fa_ops.flash_attention.launches - counts[1]) \
        == (2 * cfg.n_layers + 1, cfg.n_layers)
    ref, ref_cache = models["reference"].prefill(params, batch)
    _close(logits, ref, 1e-4)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name], 1e-4)
    no_patches = models["kernel"].prefill(params, {k: batch[k] for k in ("tokens", "positions")})[0]
    assert (no_patches - logits).abs().max() > 1e-3
    linear = torch.arange(s, device=cuda).expand(b, 3, s).int()
    assert (models["kernel"].prefill(params, {**batch, "positions": linear})[0]
            - logits).abs().max() > 1e-3


@pytest.mark.parametrize("concurrency", ["threads", "sequential"])
def test_fleet_of_three_executors_migrates_on_one_card(cuda, concurrency):
    """A three-executor ``ClusterExecutor`` on ``cuda:0`` with gemma-2b
    smoke sessions (``chip_smoke.fleet_run``, paging on): it migrates, its
    logs equal the port's ``Cluster``'s and every session's tokens repeat
    bit for bit (the helper's checks), and K1 and K3 are launched exactly
    a request's count a request."""
    from chip_smoke import fleet_run, fleet_sessions, kernel_counters, launches_per_request

    cfg = get_config("gemma-2b").smoke()
    specs = fleet_sessions(cfg, cuda)
    r = fleet_run(specs, cuda, True, kernel_counters(), concurrency=concurrency)
    per = launches_per_request(cfg)
    assert r["launches"]["rmsnorm"] == per["rmsnorm"] * r["iterations"] > 0
    assert r["launches"]["flash_attention"] == per["flash_attention"] * r["iterations"] > 0
    assert r["moves"] and all(m["out_gb"] > 0 and m["in_s"] > 0 for m in r["moves"])


@pytest.mark.parametrize("shape,block", [((4099, 1000), 256), ((37,), 16), ((3, 5, 7), 64)])
def test_compress_payload_on_cuda_equals_cpu(cuda, shape, block):
    """The int8 payload and fp32 scales of a CUDA tensor equal those of
    the same values on the CPU, bit for bit."""
    from repro_torch.train.grad_compress import compress, decompress

    gen = torch.Generator(device=cuda).manual_seed(block)
    x = torch.randn(shape, generator=gen, device=cuda) * 10.0 ** torch.randint(
        -3, 4, shape, generator=gen, device=cuda)
    ours, cpu = compress(x, block), compress(x.cpu(), block)
    assert torch.equal(ours["q"].cpu(), cpu["q"])
    assert torch.equal(ours["scale"].cpu().view(torch.int32), cpu["scale"].view(torch.int32))
    y = decompress(ours, x.shape, block)
    assert y.is_cuda and torch.equal(y.cpu(), decompress(cpu, x.shape, block))


def test_checkpoint_round_trip_of_cuda_leaves(cuda, tmp_path):
    """CUDA leaves (fp32, bf16, int64) saved asynchronously and updated in
    place before the writer runs: the checkpoint holds the values at the
    save, bit for bit, and restores into a CUDA template's dtypes."""
    import threading

    from repro_torch.ckpt.checkpoint import CheckpointManager

    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(300, 70, generator=gen, device=cuda),
            "h": torch.randn(64, generator=gen, device=cuda).to(torch.bfloat16),
            "step": torch.tensor(3, dtype=torch.int64, device=cuda)}
    before = {k: v.cpu() for k, v in tree.items()}
    mgr = CheckpointManager(tmp_path)
    gate = threading.Event()
    write = mgr._write
    mgr._write = lambda *a: (gate.wait(10), write(*a))
    mgr.save(1, tree)
    for t in tree.values():
        t.add_(1)
    gate.set()
    mgr.wait()
    _, restored, _ = mgr.restore_tree(tree)
    for k, v in restored.items():
        assert v.dtype == before[k].dtype and torch.equal(v, before[k]), k


def test_ckpt_phase_runs_at_smoke_size(cuda, tmp_path, monkeypatch):
    """``chip_smoke.ckpt_runs`` on gemma-2b smoke: the killed-and-restored
    run and the checkpoint-migrated session equal the uninterrupted ones
    bit for bit, the compression checks hold, and the kernels launch
    exactly a step's count a step (its checks), on a one-rank NCCL group."""
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.runtime import adamw_config_for
    from repro_torch.train.train_step import TrainRunConfig

    monkeypatch.setattr(cs, "CKPT_BLOCK", 16)  # the smoke leaves are multiples of 16
    cfg = get_config("gemma-2b").smoke()
    model = build_model(cfg, ModelOptions(loss_chunk=8))
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        res = cs.ckpt_runs(cfg, ShapeConfig("t", "train", 64, 4), model,
                           TrainRunConfig(num_microbatches=2), adamw_config_for(cfg),
                           cuda, mesh, str(tmp_path))
    finally:
        dist.destroy_process_group()
    assert res["restarts"] == 1 and res["left"] == ["step_00000003", "step_00000004"]
    assert res["launches"]["A"]["rmsnorm"] > 0 and res["launches"]["A"]["flash_attention_bwd"] > 0


CLI_SMOKE = ("--seq-len", "64", "--batch", "4", "--microbatches", "4", "--log-every", "1")


def test_cli_resumes_bit_for_bit_at_smoke_size(cuda, tmp_path):
    """``chip_smoke.cli_resume`` on gemma-2b smoke through the training
    CLI's loop on a one-rank NCCL group: a run saved every 2 steps, the
    same killed at step 3 and resumed from step 2, its final checkpoint
    bit for bit the first's, and a second call resuming from a meta
    template (the helper's checks); the kernels launch exactly a step's
    count a step."""
    import chip_smoke as cs

    cfg = get_config("gemma-2b").smoke()
    per_step = {k: 4 * v for k, v in cs.launches_per_microbatch(cfg).items()}
    res = cs.cli_resume(cfg, CLI_SMOKE, str(tmp_path), cs.kernel_counters(), per_step)
    assert res["B"]["resumed"] == [2] and res["C"]["resumed"] == [4]
    assert res["A"]["launches"]["flash_attention_bwd"] > 0


@pytest.mark.parametrize("extra,passes", [((), 4), (("--compress-grads",), 1)])
def test_cli_steps_at_smoke_size(cuda, extra, passes):
    """The CLI's loop on the card, with and without ``--compress-grads``:
    finite losses and exactly a pass's launches a microbatch (the
    compressed path takes one pass of the whole batch)."""
    import chip_smoke as cs

    cfg = get_config("gemma-2b").smoke()
    per = cs.launches_per_microbatch(cfg)
    rec = cs.cli_run(cfg, [*CLI_SMOKE, "--steps", "3", *extra], cs.kernel_counters(),
                     {k: 3 * passes * v for k, v in per.items()})
    assert sorted(rec["losses"]) == [0, 1, 2] and rec["restarts"] == 0


def test_cli_refuses_rwkv_on_the_card(cuda):
    from repro_torch.launch.train import main

    with pytest.raises(NotImplementedError, match="WKV6"):
        main(["--arch", "rwkv6-7b", "--smoke"])


def test_quickstart_and_inference_packing_examples_on_the_card(cuda, capsys):
    """The example twins on ``cuda``: quickstart admits two jobs and
    queues the third; inference_packing packs all 12 services and serves
    every request, its rwkv services through K4 under ``no_grad``."""
    import chip_smoke as cs

    report = cs.load_example("quickstart").main(["--device", "cuda"])
    assert "lanes: 2, queued: 1" in capsys.readouterr().out
    assert not report.failures
    before = wkv_ops.wkv6.launches
    res = cs.load_example("inference_packing").main(["--device", "cuda"])
    assert res["packed"] == res["services"] == 12 and res["requests"] == 144
    assert wkv_ops.wkv6.launches > before
