"""Port RMSNorm (CPU path = its plain version) vs the JAX package: the jnp
oracle and the Pallas kernel in interpret mode, on the JAX test's cases
(tests/test_kernels_rmsnorm.py) at its tolerances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

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


# ---------------------------------------------------------------------------
# the backward: the plain version (explicit formula) against jax.grad of the
# JAX package's jnp norms and against torch.autograd of the port's forward
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro.models.layers import rmsnorm as jax_layer_rmsnorm  # noqa: E402
from repro.models.layers import rmsnorm_head as jax_rmsnorm_head  # noqa: E402
from repro_torch.kernels.fused_rmsnorm.ref import rmsnorm_bwd_ref, rmsnorm_ref  # noqa: E402


def _jax_vjp(fn, x, scale, g):
    _, vjp = jax.vjp(fn, x, scale)
    return vjp(g)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("form", ["layer", "head"])
def test_rmsnorm_bwd_ref_vs_jax_grad(shape, dtype, form):
    """``rmsnorm_bwd_ref`` against ``jax.vjp`` of ``layers.rmsnorm`` (the
    block norms) and ``layers.rmsnorm_head`` (qk-norm)."""
    jdt, tdt, tol = DTYPES[dtype]
    x, scale, _ = _inputs(shape, False)
    g = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    jx, tx = _pair(x, jdt, tdt)
    js, ts = _pair(scale, jdt, tdt)
    jg, tg = _pair(g, jdt, tdt)
    if form == "layer":
        fn = lambda a, s: jax_layer_rmsnorm({"scale": s}, a)
    else:
        fn = lambda a, s: jax_rmsnorm_head(s, a)
    jdx, jds = _jax_vjp(fn, jx, js, jg)
    dx, ds = rmsnorm_bwd_ref(tg, tx, ts)
    assert dx.dtype == tdt and ds.dtype == tdt and dx.shape == tx.shape
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(jdx, np.float32), rtol=tol, atol=tol)
    # dscale sums over every row: scale the tolerance by the row count
    rows = int(np.prod(shape[:-1]))
    np.testing.assert_allclose(ds.float().numpy(), np.asarray(jds, np.float32),
                               rtol=tol, atol=tol * np.sqrt(rows))


@pytest.mark.parametrize("shape", SHAPES + [(3, 5, 128), (2, 20001)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rmsnorm_bwd_ref_vs_torch_autograd(shape, dtype):
    _, tdt, tol = DTYPES[dtype]
    x, scale, _ = _inputs(shape, False)
    g = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32)).to(tdt)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts = torch.from_numpy(scale).to(tdt).requires_grad_()
    rmsnorm_ref(tx, ts).backward(g)
    dx, ds = rmsnorm_bwd_ref(g, tx.detach(), ts.detach())
    torch.testing.assert_close(dx.float(), tx.grad.float(), rtol=tol, atol=tol)
    rows = int(np.prod(shape[:-1]))
    torch.testing.assert_close(ds.float(), ts.grad.float(), rtol=tol, atol=tol * np.sqrt(rows))
    # the CPU wrapper is the plain version, and counts no launch
    before = ops.rmsnorm_bwd.launches
    dx2, ds2 = ops.rmsnorm_bwd(g, tx.detach(), ts.detach())
    assert torch.equal(dx2, dx) and torch.equal(ds2, ds)
    assert ops.rmsnorm_bwd.launches == before


def test_rmsnorm_cpu_autograd_goes_through_the_plain_version():
    x, scale, r = _inputs((4, 64), True)
    tx = torch.from_numpy(x).requires_grad_()
    ts = torch.from_numpy(scale).requires_grad_()
    out = ops.rmsnorm(tx, ts, torch.from_numpy(r))  # the residual form too, on the CPU
    out.sum().backward()
    assert tx.grad is not None and ts.grad is not None


@pytest.mark.parametrize(
    "d,element_size,expected",
    [
        (2048, 2, (8, 128, 2, 4, 3)),  # gemma-2b's rows: 128 threads of two vectors, 4 slots
        (1024, 2, (8, 128, 1, 4, 3)),  # the forward's shape
        (128, 2, (8, 16, 1, 32, 3)),  # qk-norm rows: 32 slots of a half-warp
        (4096, 4, (4, 256, 4, 2, 1)),  # rows of 16 KB: one a slot in flight
        (8192, 4, (4, 256, 8, 2, 1)),  # 32 values a thread: still in registers
        (16384, 2, (8, 512, 0, 1, 1)),  # 64 values a thread would spill: the loop
        (16384, 4, (4, 512, 0, 1, 1)),
        (20001, 2, (1, 512, 0, 1, 1)),
    ],
)
def test_rmsnorm_bwd_launch_shape(d, element_size, expected):
    shape = ops.bwd_launch_shape(d, element_size)
    assert tuple(shape) == expected
    assert shape.vectors_per_thread * shape.vec <= ops.BWD_REGISTER_VALUES
    if shape.vectors_per_thread == 0:
        assert shape.threads_per_row == ops.BWD_BLOCK
    assert shape.threads_per_row * shape.rows_per_block == ops.BWD_BLOCK
    assert ops.bwd_smem_bytes(shape, d, element_size) <= ops.BWD_MAX_SMEM


def test_rmsnorm_bwd_blocks():
    gemma = ops.bwd_launch_shape(2048, 2)
    assert ops.bwd_blocks(4096, gemma, 132) == 132  # one an SM
    qk = ops.bwd_launch_shape(128, 2)
    assert ops.bwd_blocks(5, qk, 132) == 1  # one row group
    assert ops.bwd_blocks(0, gemma, 132) == 1


@pytest.mark.parametrize("element_size", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_bwd_launch_shape_covers_every_row(element_size, aligned):
    """Every d up to 40000: a slot's threads cover the row, the ring and
    the block's dscale rows fit the shared memory the kernel asks for, and
    only 16-byte loads get a ring deeper than one row."""
    for d in range(1, 40001, 13):
        s = ops.bwd_launch_shape(d, element_size, aligned)
        assert d % s.vec == 0
        assert 1 <= s.stages <= ops.BWD_MAX_STAGES
        if s.vectors_per_thread:
            assert s.threads_per_row * s.vectors_per_thread * s.vec >= d
            assert ops.bwd_smem_bytes(s, d, element_size) <= ops.BWD_MAX_SMEM
            if s.vec * element_size != ops.VECTOR_BYTES:
                assert s.stages == 1
        else:
            assert (s.threads_per_row, s.rows_per_block) == (ops.BWD_BLOCK, 1)


@pytest.mark.parametrize(
    "rows,d,element_size,sm_count",
    [(4096, 2048, 2, 132), (131072, 128, 2, 132), (8192, 4096, 4, 132), (37, 2048, 2, 2),
     (300, 64, 4, 1), (5, 16384, 2, 132), (3, 100, 2, 4)],
)
def test_rmsnorm_bwd_rows_cover_every_row_once_in_a_fixed_order(rows, d, element_size, sm_count):
    """Each row falls to exactly one (block, slot), each block's slots walk
    their rows in ascending order, and the partial rows are summed in
    block order: the plan is a function of the shapes alone, so two calls
    give the same bits."""
    shape = ops.bwd_launch_shape(d, element_size)
    blocks = ops.bwd_blocks(rows, shape, sm_count)
    plan = ops.bwd_rows(rows, shape, blocks)
    assert len(plan) == blocks and all(len(slots) == shape.rows_per_block for slots in plan)
    walked = [r for slots in plan for mine in slots for r in mine]
    assert sorted(walked) == list(range(rows))
    assert all(mine == sorted(mine) for slots in plan for mine in slots)
    ops.bwd_launch_shape.cache_clear()
    again = ops.bwd_launch_shape(d, element_size)
    assert ops.bwd_rows(rows, again, ops.bwd_blocks(rows, again, sm_count)) == plan


def test_rmsnorm_bwd_constants_match_the_source():
    src = (ops._build.CSRC / "rmsnorm.cu").read_text()
    assert f"constexpr int kBwdBlock = {ops.BWD_BLOCK};" in src
    assert f"constexpr int kBwdMaxStages = {ops.BWD_MAX_STAGES};" in src
    assert ops.BWD_STAGES <= ops.BWD_MAX_STAGES
    assert "constexpr int kBwdMaxSmem = 128 << 10;" in src and ops.BWD_MAX_SMEM == 128 << 10
