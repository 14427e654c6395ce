"""Port RMSNorm (CPU path = its plain version) vs the JAX package: the jnp
oracle and the Pallas kernel in interpret mode, on the JAX test's cases
(tests/test_kernels_rmsnorm.py) at its tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.fused_rmsnorm.ops import rmsnorm as jax_rmsnorm  # noqa: E402
from repro.kernels.fused_rmsnorm.ref import rmsnorm_ref as jax_rmsnorm_ref  # noqa: E402
from repro_torch.kernels.fused_rmsnorm import ops  # noqa: E402

SHAPES = [(4, 16, 64), (2, 32, 128), (7, 96), (1, 1, 256)]
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(shape, residual, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(shape[-1]) * 0.1 + 1.0).astype(np.float32)
    r = rng.standard_normal(shape).astype(np.float32) if residual else None
    return x, scale, r


def _pair(a, jdt, tdt):
    if a is None:
        return None, None
    j = jnp.asarray(a).astype(jdt)
    # the same rounded values on both sides
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_vs_jax(shape, residual, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    x, scale, r = _inputs(shape, residual)
    jx, tx = _pair(x, jdt, tdt)
    js, ts = _pair(scale, jdt, tdt)
    jr, tr = _pair(r, jdt, tdt)
    out = ops.rmsnorm(tx, ts, tr)
    assert out.dtype == tdt and out.shape == tx.shape
    got = out.float().numpy()
    # the interpret-mode kernel upcasts before the residual add, as the port does
    kern = np.asarray(jax_rmsnorm(jx, js, jr, interpret=True), np.float32)
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)
    if not residual or dtype == "float32":
        ref = np.asarray(jax_rmsnorm_ref(jx, js, jr), np.float32)
        np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_rmsnorm_cpu_path_never_counts_a_launch():
    x, scale, _ = _inputs((3, 8), False)
    before = ops.rmsnorm.launches
    ops.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))
    assert ops.rmsnorm.launches == before


# ---------------------------------------------------------------------------
# the CUDA kernel's launch shape (a Python helper; the kernel itself runs
# only on the card, tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "d,element_size,aligned,expected",
    [
        (128, 2, True, (8, 16, 1, 16)),  # q/k-norm rows: a half-warp a row
        (128, 4, True, (4, 32, 1, 8)),
        (2048, 2, True, (8, 256, 1, 1)),
        (4096, 2, True, (8, 256, 2, 1)),  # 256 threads a row, two 16-byte vectors each
        (4096, 4, True, (4, 256, 4, 1)),
        (100, 2, True, (1, 128, 1, 2)),  # not a multiple of 8: scalar loads
        (4096, 2, False, (1, 256, 16, 1)),  # a pointer off 16 bytes: scalar loads
        (20001, 2, True, (1, 256, 0, 1)),  # more than 16 a thread: the looping form
        (1, 4, True, (1, 1, 1, 256)),
    ],
)
def test_rmsnorm_launch_shape(d, element_size, aligned, expected):
    assert tuple(ops.launch_shape(d, element_size, aligned)) == expected


@pytest.mark.parametrize("element_size", [2, 4])
def test_rmsnorm_launch_shape_covers_every_row(element_size):
    """Every d up to 40000: the threads of a row (a power of two within
    one block) times what each holds cover the row, with no more than one
    vector a thread to spare beyond a power of two."""
    for d in range(1, 40001, 7):
        s = ops.launch_shape(d, element_size)
        assert s.threads_per_row & (s.threads_per_row - 1) == 0
        assert s.threads_per_row * s.rows_per_block == ops.BLOCK
        assert d % s.vec == 0
        n_vec = d // s.vec
        if s.vectors_per_thread:
            assert s.threads_per_row * s.vectors_per_thread >= n_vec
            assert s.threads_per_row * s.vectors_per_thread < 2 * n_vec + ops.BLOCK
        else:
            assert n_vec > 16 * ops.BLOCK
