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
@pytest.mark.parametrize("shape", [(3, 5, 128), (7, 2048), (64, 4096), (1, 100)])
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
    report, ex = serve.serve(serve.build_parser().parse_args(
        ["--device", "cuda", "--smoke", "--requests", "2", "--rps", "4", "--duration", "1"]
    ))
    assert not report.failures
    served = sum(st.iterations_done for st in report.stats.values())
    assert served == sum(s.n_iters for s in ex.sessions.values()) > 0
    assert rms_ops.rmsnorm.launches > rms0 and fa_ops.flash_attention.launches > fa0


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
