"""Port flash attention (CPU path = its plain version) vs the JAX package:
the jnp oracle on the JAX test's cases (tests/test_kernels_flash.py) at its
tolerances, the Pallas kernel in interpret mode on two of them, the
q_offset suffix, the ragged rejection and a fully-masked row."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops  # noqa: E402

CASES = [
    # (b, sq, hq, hkv, d, causal, window, bq, bk)
    (2, 128, 4, 2, 64, True, None, 64, 64),
    (1, 256, 8, 1, 32, True, None, 128, 64),   # MQA
    (2, 256, 4, 4, 64, True, 64, 64, 64),      # SWA
    (1, 128, 2, 2, 128, False, None, 64, 64),  # bidirectional
    (1, 512, 6, 3, 64, True, 128, 128, 128),   # GQA + SWA
    (3, 64, 2, 1, 16, True, None, 64, 32),     # odd batch, tiny head
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(b, sq, sk, hq, hkv, d, jdt, tdt, seed):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.standard_normal(shape).astype(np.float32)
        for shape in ((b, sq, hq, d), (b, sk, hkv, d), (b, sk, hkv, d))
    ]
    js = [jnp.asarray(a).astype(jdt) for a in arrays]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt) for j in js]
    return js, ts


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_vs_jax_oracle(case, dtype):
    b, s, hq, hkv, d, causal, window, bq, bk = case
    jdt, tdt, tol = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, s, hq, hkv, d, jdt, tdt, seed=CASES.index(case))
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window, block_q=bq, block_k=bk)
    assert out.dtype == tdt and out.shape == (b, s, hq, d)
    ref = np.asarray(jax_ref(jq, jk, jv, causal=causal, window=window), np.float32)
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", [CASES[1], CASES[4]])
def test_flash_vs_jax_interpret_kernel(case):
    b, s, hq, hkv, d, causal, window, bq, bk = case
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, s, hq, hkv, d, jnp.float32, torch.float32, seed=7)
    out = ops.flash_attention(tq, tk, tv, causal=causal, window=window, block_q=bq, block_k=bk)
    kern = jax_flash(jq, jk, jv, causal=causal, window=window, block_q=bq, block_k=bk,
                     interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(kern), rtol=2e-5, atol=2e-5)


def test_flash_q_offset_matches_suffix():
    """Decode-style: queries are a suffix of the sequence."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 256, 256, 2, 2, 64, jnp.float32, torch.float32, seed=3)
    full = np.asarray(jax_ref(jq, jk, jv, causal=True))
    tail = ops.flash_attention(tq[:, 128:], tk, tv, causal=True, q_offset=128, block_q=64, block_k=64)
    np.testing.assert_allclose(tail.numpy(), full[:, 128:], rtol=2e-5, atol=2e-5)


def test_flash_rejects_ragged():
    q = torch.zeros((1, 100, 2, 16))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, block_q=64, block_k=64)


def test_flash_fully_masked_rows_give_zero():
    """A negative offset leaves the first queries with no valid key: the
    kernels (Pallas and the port's) output 0 there."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, 64, 64, 2, 1, 16, jnp.float32, torch.float32, seed=4)
    out = ops.flash_attention(tq, tk, tv, causal=True, q_offset=-16, block_q=32, block_k=32)
    kern = np.asarray(jax_flash(jq, jk, jv, causal=True, q_offset=-16, block_q=32, block_k=32,
                                interpret=True))
    assert np.all(out[:, :16].numpy() == 0.0)
    np.testing.assert_allclose(out.numpy(), kern, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the CUDA wrapper's route and TMA geometry (Python helpers; the kernels
# themselves run only on the card, tests/test_torch_gpu.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "dtype,d,expected",
    [
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 256, "wgmma"),
        (torch.bfloat16, 16, "simt"),
        (torch.bfloat16, 32, "simt"),
        (torch.float32, 128, "simt"),
        (torch.float32, 256, "simt"),
    ],
)
def test_flash_route_by_dtype_and_head_dim(dtype, d, expected):
    assert ops.route(dtype, d) == expected


@pytest.mark.parametrize(
    "dtype,d,expected",
    [
        (torch.bfloat16, 64, "wgmma"),
        (torch.bfloat16, 128, "wgmma"),
        (torch.bfloat16, 256, "wgmma"),
        (torch.bfloat16, 16, "simt"),
        (torch.bfloat16, 32, "simt"),
        (torch.float32, 64, "mma_tf32"),
        (torch.float32, 128, "mma_tf32"),
        (torch.float32, 256, "mma_tf32"),
    ],
)
def test_flash_bwd_route_by_dtype_and_head_dim(dtype, d, expected):
    """The backward's rule: d 64/128/256 on the tensor cores, ``wgmma`` in
    bf16 and 3xTF32 ``mma.sync`` in fp32 (held to 1e-5); d 16/32 on the
    SIMT kernels. The forward's rule is unchanged (fp32 stays SIMT). The C
    entry point applies the same test (`d in {64, 128, 256}`, then the
    dtype) and asks for the plan on both tensor-core routes."""
    assert ops.bwd_route(dtype, d) == expected
    assert ops.route(dtype, d) == ("wgmma" if expected == "wgmma" else "simt")
    src = (ops._build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "const bool tensor_cores = d == 64 || d == 128 || d == 256;" in src
    assert "if (dtype == 0 && tensor_cores) {" in src
    assert "if (dtype == 1 && tensor_cores) {" in src


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", ops.HEAD_DIMS)
def test_flash_bwd_route_covers_every_dtype_and_head_dim(dtype, d):
    """Every dtype and head size the wrapper takes has exactly one
    backward route, and the tensor-core ones are the head sizes a 64-column
    box or fragment tiles."""
    r = ops.bwd_route(dtype, d)
    assert r in ("wgmma", "mma_tf32", "simt")
    assert (r != "simt") == (d in ops.WGMMA_HEAD_DIMS)


# (b, sq, sk, hq, hkv, d, causal): gemma-2b and qwen3-8b at (1, 4096),
# ragged tiles, an odd number of key tiles, MQA and GQA, no causal mask
PLAN_CASES = [
    (1, 4096, 4096, 8, 1, 256, True),
    (1, 4096, 4096, 32, 8, 128, True),
    (2, 100, 100, 8, 2, 64, True),
    (1, 64, 320, 4, 1, 128, True),
    (3, 13, 13, 8, 1, 256, True),
    (1, 128, 100, 4, 2, 64, False),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_flash_bwd_plan_covers_each_key_tile_and_head_once(case):
    """Every (batch, key tile, query head) falls in exactly one dK/dV
    block, whose kv head is that query head's, and the plan's block count
    is the grid's."""
    b, sq, sk, hq, hkv, d, causal = case
    plan = ops.bwd_plan(b, sq, sk, hq, hkv, d, causal)
    blocks = list(ops.bwd_blocks(plan, b, hq, hkv))
    assert len(blocks) == plan.dkdv_blocks
    seen = [(bi, t, h) for bi, hk, _, tiles, heads in blocks for t in tiles for h in heads
            if h // (hq // hkv) == hk]
    want = [(bi, t, h) for bi in range(b) for t in range(-(-sk // 64)) for h in range(hq)]
    assert len(seen) == sum(len(tl) * len(hs) for _, _, _, tl, hs in blocks)
    assert sorted(seen) == want
    assert plan.dq_blocks == -(-sq // 64) * hq * b


def test_flash_bwd_plan_balances_the_causal_triangle():
    """Under the causal mask a block takes key tiles p and n - 1 - p: at
    (1, 4096) every block walks 65 query tiles a head."""
    plan = ops.bwd_plan(1, 4096, 4096, 8, 1, 256, True)
    n = plan.key_tiles
    for *_, tiles, _ in ops.bwd_blocks(plan, 1, 8, 1):
        assert sum(n - t for t in tiles) == n + 1


def test_flash_bwd_plan_fills_the_card_at_gemma_2b():
    """gemma-2b's single kv head at (1, 4096): 32 key-tile pairs, so the 8
    query heads are split 4 ways for 128 dK/dV blocks; qwen3-8b's 8 kv
    heads need no split."""
    gemma = ops.bwd_plan(1, 4096, 4096, 8, 1, 256, True)
    assert gemma.splits == 4 and gemma.dkdv_blocks >= 128
    qwen = ops.bwd_plan(1, 4096, 4096, 32, 8, 128, True)
    assert qwen.splits == 1 and qwen.dkdv_blocks == 256 and qwen.scratch_bytes == 0


@pytest.mark.parametrize("case", PLAN_CASES)
def test_flash_bwd_plan_scratch_bytes(case):
    """fp32 partial dK and dV, one of each a split, only when split: 32 MiB
    at gemma-2b's (1, 4096)."""
    b, sq, sk, hq, hkv, d, causal = case
    plan = ops.bwd_plan(b, sq, sk, hq, hkv, d, causal)
    assert (hq // hkv) % plan.splits == 0
    want = 2 * plan.splits * b * sk * hkv * d * 4 if plan.splits > 1 else 0
    assert plan.scratch_bytes == want
    if case[:6] == (1, 4096, 4096, 8, 1, 256):
        assert plan.scratch_bytes == 32 * 2**20


@pytest.mark.parametrize("case", PLAN_CASES)
def test_flash_bwd_plan_fixes_the_summation_order(case):
    """A key tile's dK and dV sum its query heads in ascending order inside
    a block and the splits in ascending order after, whatever the launch
    order: the plan is a function of the shapes alone, so two calls give
    the same bits."""
    b, sq, sk, hq, hkv, d, causal = case
    plan = ops.bwd_plan(b, sq, sk, hq, hkv, d, causal)
    order = {}
    for bi, hk, g, tiles, heads in ops.bwd_blocks(plan, b, hq, hkv):
        assert list(heads) == sorted(heads)
        for t in tiles:
            order.setdefault((bi, hk, t), []).append((g, heads))
    for parts in order.values():
        assert [g for g, _ in parts] == list(range(plan.splits))
        flat = [h for _, hs in parts for h in hs]
        assert flat == sorted(flat)
    ops.bwd_plan.cache_clear()
    assert ops.bwd_plan(b, sq, sk, hq, hkv, d, causal) == plan


def test_flash_bwd_source_has_no_device_atomics():
    """Runs repeat bit for bit: no atomic operation in the backward
    kernels, flash attention's and RMSNorm's (each source's only
    `std::atomic` is a host flag)."""
    import re

    for name in ("flash_attention_bwd.cu", "rmsnorm.cu"):
        src = (ops._build.CSRC / name).read_text()
        assert not re.search(
            r"\batomic(Add|Sub|Max|Min|Inc|Dec|CAS|Exch|And|Or|Xor)|\batom\.|\bred\.", src), name
        assert "std::atomic<uint64_t>" in src, name


# (b, sq, sk, hq, hkv, d, causal, window, q_offset) on the fp32 tensor-core
# route: the parity prompt (1, 512) with qwen3-8b's heads, the train_parity
# shape (1, 4096) with gemma-2b's, a window, a query suffix, ragged tiles
TF32_PLAN_CASES = [
    (1, 512, 512, 32, 8, 128, True, None, 0),
    (1, 4096, 4096, 8, 1, 256, True, None, 0),
    (1, 300, 300, 4, 1, 64, True, 100, 0),
    (1, 64, 192, 8, 2, 256, True, None, 128),
    (2, 100, 100, 8, 2, 64, False, None, 0),
]


@pytest.mark.parametrize("case", TF32_PLAN_CASES)
def test_flash_bwd_tf32_plan_covers_each_key_tile_head_and_query_once(case):
    """The fp32 route runs on ``bwd_plan``: every (batch, key tile, query
    head) falls in one dK/dV block, and the query steps the block walks for
    a key tile (64, 32 or 16 rows at d 64, 128, 256) hold every query that sees one
    of its keys exactly once."""
    b, sq, sk, hq, hkv, d, causal, window, q_offset = case
    assert ops.bwd_route(torch.float32, d) == "mma_tf32"
    plan = ops.bwd_plan(b, sq, sk, hq, hkv, d, causal)
    seen = [(bi, t, h) for bi, _, _, tiles, heads in ops.bwd_blocks(plan, b, hq, hkv)
            for t in tiles for h in heads]
    assert sorted(seen) == [(bi, t, h) for bi in range(b) for t in range(plan.key_tiles)
                            for h in range(hq)]
    rows = ops.tf32_stream_rows(d)
    mask = torch.ones(sq, sk, dtype=torch.bool)
    qpos, kpos = torch.arange(sq)[:, None] + q_offset, torch.arange(sk)[None, :]
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= kpos > qpos - window
    for t in range(plan.key_tiles):
        k0 = t * ops.BWD_TILE
        steps = list(ops.bwd_query_steps(k0, rows, sq, sk, causal, window, q_offset))
        walked = [q for q0 in steps for q in range(q0, min(q0 + rows, sq))]
        assert len(walked) == len(set(walked))
        need = set(torch.nonzero(mask[:, k0:k0 + ops.BWD_TILE].any(dim=1)).flatten().tolist())
        assert need <= set(walked)
        assert all(q0 % rows == 0 for q0 in steps)


@pytest.mark.parametrize("case", TF32_PLAN_CASES)
def test_flash_bwd_tf32_plan_fixes_the_summation_order(case):
    """On the fp32 route as on bf16: a key tile's dK and dV sum its query
    heads in ascending order in a block, the query steps in ascending
    order, and the splits in ascending order after; the plan is a function
    of the shapes alone."""
    b, sq, sk, hq, hkv, d, causal, window, q_offset = case
    plan = ops.bwd_plan(b, sq, sk, hq, hkv, d, causal)
    order = {}
    for bi, hk, g, tiles, heads in ops.bwd_blocks(plan, b, hq, hkv):
        assert list(heads) == sorted(heads)
        for t in tiles:
            order.setdefault((bi, hk, t), []).append(g)
    assert all(gs == list(range(plan.splits)) for gs in order.values())
    rows = ops.tf32_stream_rows(d)
    for t in range(plan.key_tiles):
        steps = list(ops.bwd_query_steps(t * 64, rows, sq, sk, causal, window, q_offset))
        assert steps == sorted(steps)
    ops.bwd_plan.cache_clear()
    assert ops.bwd_plan(b, sq, sk, hq, hkv, d, causal) == plan


def test_flash_bwd_tf32_stream_rows_match_the_source():
    src = (ops._build.CSRC / "flash_attention_bwd.cu").read_text()
    assert "constexpr int kTcStream = D == 256 ? 16 : D == 128 ? 32 : 64;" in src
    assert [ops.tf32_stream_rows(d) for d in (64, 128, 256)] == [64, 32, 16]


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tma_geometry_contiguous(d):
    t = torch.zeros((2, 100, 8, d), dtype=torch.bfloat16)
    g = ops.tma_geometry(t.shape, t.stride(), t.data_ptr(), t.element_size())
    assert g.dims == (d, 8, 100, 2)
    assert g.strides == (2 * d, 2 * d * 8, 2 * d * 8 * 100)
    assert g.box == (64, 1, 64, 1)


@pytest.mark.parametrize("d", [64, 128, 256])
def test_tma_geometry_strided_view(d):
    """q/k/v as views of one (b, s, 3, h, d) projection: no copy, the
    sequence and batch strides step over the other two."""
    qkv = torch.zeros((2, 64, 3, 4, d), dtype=torch.bfloat16)
    q, k, _ = qkv.unbind(2)
    gq = ops.tma_geometry(q.shape, q.stride(), q.data_ptr(), 2)
    gk = ops.tma_geometry(k.shape, k.stride(), k.data_ptr(), 2)
    assert gq.dims == gk.dims == (d, 4, 64, 2)
    assert gq.strides == gk.strides == (2 * d, 2 * d * 12, 2 * d * 12 * 64)
    assert gk.box == (64, 1, 64, 1)


def test_tma_geometry_size_one_dims_take_inner_extent():
    """A dimension of size 1 is never stepped over: its stride, whatever
    the view says, is replaced by the extent inside it."""
    g = ops.tma_geometry((1, 5, 1, 128), (7, 384, 3, 1), 0x1000, 2)
    assert g.dims == (128, 1, 5, 1)
    assert g.strides == (256, 768, 768 * 5)


@pytest.mark.parametrize(
    "shape,strides,ptr,match",
    [
        ((1, 64, 2, 64), (8320, 130, 65, 1), 0x1000, "head strides"),  # 130-byte heads
        ((2, 64, 2, 64), (8196, 128, 64, 1), 0x1000, "batch strides"),
        ((1, 64, 2, 64), (8192, 128, 64, 1), 0x1002, "aligned base"),
        ((1, 64, 2, 64), (8192, 128, 64, 2), 0x1000, "contiguous last"),
    ],
)
def test_tma_geometry_refuses_misaligned(shape, strides, ptr, match):
    with pytest.raises(ValueError, match=match):
        ops.tma_geometry(shape, strides, ptr, 2)


# ---------------------------------------------------------------------------
# the backward: the plain versions against jax.grad of the JAX oracle and
# against torch.autograd of the port's forward
# ---------------------------------------------------------------------------

import jax  # noqa: E402

from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

GRAD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def _grads_inputs(case, dtype, seed):
    b, s, hq, hkv, d = case[:5]
    jdt, tdt, _ = DTYPES[dtype]
    (jq, jk, jv), (tq, tk, tv) = _qkv(b, s, s, hq, hkv, d, jdt, tdt, seed=seed)
    g = np.random.default_rng(seed + 100).standard_normal((b, s, hq, d)).astype(np.float32)
    jg = jnp.asarray(g).astype(jdt)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(tdt)
    return (jq, jk, jv, jg), (tq, tk, tv, tg)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_attention_bwd_ref_vs_jax_grad(case, dtype):
    """``attention_lse_ref`` + ``attention_bwd_ref`` against ``jax.vjp`` of
    the JAX package's ``attention_ref`` (no fully-masked rows here, where
    the two oracles differ by design)."""
    b, s, hq, hkv, d, causal, window, _, _ = case
    (jq, jk, jv, jg), (tq, tk, tv, tg) = _grads_inputs(case, dtype, CASES.index(case))
    kw = dict(causal=causal, window=window)
    grads = jax.jit(lambda q, k, v, g: jax.vjp(lambda *a: jax_ref(*a, **kw), q, k, v)[1](g))
    jdq, jdk, jdv = grads(jq, jk, jv, jg)
    out, lse = attention_lse_ref(tq, tk, tv, **kw)
    assert lse.dtype == torch.float32 and lse.shape == (b, hq, s)
    assert torch.isfinite(lse).all()
    dq, dk, dv = attention_bwd_ref(tg, tq, tk, tv, out, lse, **kw)
    tol = GRAD_TOL[dtype]
    for ours, theirs in ((dq, jdq), (dk, jdk), (dv, jdv)):
        assert ours.dtype == tq.dtype
        a, b_ = ours.float().numpy(), np.asarray(theirs, np.float32)
        # held as a whole: || ours - jax || / || jax ||
        assert np.linalg.norm(a - b_) <= tol * np.linalg.norm(b_)


@pytest.mark.parametrize(
    "case",
    CASES + [
        (1, 64, 2, 1, 16, True, None, 64, 64),  # the suffix and fully-masked cases below
    ],
)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("q_offset", [0, 32, -16])
def test_attention_bwd_ref_vs_torch_autograd(case, dtype, q_offset):
    """The explicit formulas against autograd of the port's ``attention_ref``
    (which gives 0 for a query with no valid key), with a query offset: a
    suffix of the sequence (32) and leading fully-masked rows (-16)."""
    b, s, hq, hkv, d, causal, window, _, _ = case
    _, (tq, tk, tv, tg) = _grads_inputs(case, dtype, 7)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v = (t.clone().requires_grad_() for t in (tq, tk, tv))
    attention_ref(q, k, v, **kw).backward(tg)
    out, lse = attention_lse_ref(tq, tk, tv, **kw)
    dq, dk, dv = attention_bwd_ref(tg, tq, tk, tv, out, lse, **kw)
    tol = GRAD_TOL[dtype]
    for ours, theirs in ((dq, q.grad), (dk, k.grad), (dv, v.grad)):
        assert torch.isfinite(ours.float()).all()
        assert (ours.float() - theirs.float()).norm() <= tol * theirs.float().norm() + 1e-6
    # the CPU wrapper is the plain version, and counts no launch
    before = ops.flash_attention_bwd.launches
    got = ops.flash_attention_bwd(tg, tq, tk, tv, out, lse, **kw)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, (dq, dk, dv)))
    assert ops.flash_attention_bwd.launches == before


def test_attention_fully_masked_rows_give_zero_gradients():
    """Queries with no valid key (a negative offset): lse is -inf there,
    their dq is 0 and nothing is NaN."""
    _, (tq, tk, tv, tg) = _grads_inputs((1, 64, 2, 1, 16), "float32", 5)
    kw = dict(causal=True, q_offset=-16)
    out, lse = attention_lse_ref(tq, tk, tv, **kw)
    assert torch.isinf(lse[:, :, :16]).all() and (lse[:, :, :16] < 0).all()
    assert torch.isfinite(lse[:, :, 16:]).all()
    dq, dk, dv = attention_bwd_ref(tg, tq, tk, tv, out, lse, **kw)
    for t in (dq, dk, dv):
        assert not torch.isnan(t).any()
    assert (dq[:, :16] == 0).all() and (dq[:, 16:] != 0).any()


def test_attention_lse_matches_jax_logsumexp():
    b, s, hq, hkv, d = 2, 64, 4, 2, 32
    (jq, jk, _), (tq, tk, tv) = _qkv(b, s, s, hq, hkv, d, jnp.float32, torch.float32, seed=11)
    _, lse = attention_lse_ref(tq, tk, tv, causal=True, window=16)
    qg = jq.reshape(b, s, hkv, hq // hkv, d)
    logits = jnp.einsum("bqhrd,bkhd->bhrqk", qg, jk) * d ** -0.5
    pos = jnp.arange(s)
    mask = (pos[:, None] >= pos[None, :]) & (pos[None, :] > pos[:, None] - 16)
    want = jax.scipy.special.logsumexp(jnp.where(mask, logits, -jnp.inf), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(b, hq, s), rtol=1e-5, atol=1e-5)


def test_flash_cpu_autograd_goes_through_the_plain_version():
    _, (tq, tk, tv, tg) = _grads_inputs(CASES[0], "float32", 3)
    q = tq.clone().requires_grad_()
    out = ops.flash_attention(q, tk, tv, block_q=64, block_k=64)
    out.backward(tg)
    assert q.grad is not None and torch.isfinite(q.grad).all()


# ---------------------------------------------------------------------------
# the fp32 route's 3xTF32 scheme, rehearsed on the CPU: attention_bwd_ref's
# five products with each fp32 operand split into two TF32 parts
# ---------------------------------------------------------------------------


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 (10-bit mantissa, round to nearest, ties away
    from zero) by bit operations, as ``hopper::tf32`` does on the card."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _einsum_3xtf32(eq: str, a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``einsum`` of fp32 operands as the tensor cores take them: big =
    tf32(x), small = tf32(x - big), big·big + big·small + small·big summed
    in fp32 (``passes = 1``: plain TF32, big·big only). Each product of
    two TF32 values is exact in fp32, so the sums are the only fp32
    rounding, as in the mma's accumulator."""
    a_big, b_big = _tf32(a), _tf32(b)
    out = torch.einsum(eq, a_big, b_big)
    if passes == 3:
        a_small, b_small = _tf32(a.float() - a_big), _tf32(b.float() - b_big)
        out = torch.einsum(eq, a_small, b_big) + torch.einsum(eq, a_big, b_small) + out
    return out


def _bwd_by_products(dout, q, k, v, out, lse, prod, dtype, **kw):
    """``attention_bwd_ref``'s formulas in ``dtype`` with every product
    (S, dP, dV, dK, dQ) through ``prod(eq, a, b)``."""
    from repro_torch.kernels.flash_attention.ref import _mask

    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    scale = d ** -0.5
    qg = q.to(dtype).reshape(b, sq, hkv, n_rep, d)
    go = dout.to(dtype).reshape(b, sq, hkv, n_rep, d)
    s = prod("bqhrd,bkhd->bhrqk", qg, k.to(dtype)) * scale
    mask = _mask(sq, sk, kw["causal"], kw["window"], kw["q_offset"], q.device)
    lse_g = lse.to(dtype).reshape(b, hkv, n_rep, sq, 1)
    live = mask & torch.isfinite(lse_g)
    p = torch.where(live, torch.exp(s - lse_g.nan_to_num(neginf=0.0)), 0.0)
    dvec = (dout.to(dtype) * out.to(dtype)).sum(-1).reshape(b, sq, hkv, n_rep)
    dvec = dvec.permute(0, 2, 3, 1)[..., None]
    ds = p * (prod("bqhrd,bkhd->bhrqk", go, v.to(dtype)) - dvec)
    dv = prod("bhrqk,bqhrd->bkhd", p, go)
    dk = prod("bhrqk,bqhrd->bkhd", ds, qg) * scale
    dq = prod("bhrqk,bkhd->bqhrd", ds, k.to(dtype)).reshape(b, sq, hq, d) * scale
    return dq, dk, dv


# (b, s, hq, hkv, d, causal, window, q_offset): causal, a window, a query
# suffix, fully-masked rows, GQA and MQA, bidirectional
TF32_CASES = [
    (1, 128, 4, 2, 64, True, None, 0),
    (1, 96, 2, 2, 128, True, 32, 0),
    (1, 64, 8, 1, 256, True, None, 64),
    (2, 64, 4, 1, 64, True, None, -16),
    (1, 80, 4, 4, 128, False, None, 0),
]


@pytest.mark.parametrize("case", TF32_CASES)
def test_flash_bwd_3xtf32_products_hold_1e5(case):
    """The fp32 route's arithmetic on the CPU: all five products in 3xTF32
    stay within 1e-5 relative Frobenius of the same formulas in fp64 (the
    tolerance the card is held to), where one TF32 pass does not."""
    b, s, hq, hkv, d, causal, window, q_offset = case
    rng = np.random.default_rng(sum(case[:5]))
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                     for shape in ((b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, hq, d)))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = attention_lse_ref(q, k, v, **kw)
    exact = _bwd_by_products(dout, q, k, v, out, lse, torch.einsum, torch.float64, **kw)
    three = _bwd_by_products(dout, q, k, v, out, lse, _einsum_3xtf32, torch.float32, **kw)
    one = _bwd_by_products(dout, q, k, v, out, lse,
                           lambda eq, a, b_: _einsum_3xtf32(eq, a, b_, passes=1),
                           torch.float32, **kw)
    rel = lambda a, w: ((a.double() - w).norm() / w.norm()).item()
    for got, want in zip(three, exact):
        assert torch.isfinite(got).all()
        assert rel(got, want) <= 1e-5
    assert max(rel(got, want) for got, want in zip(one, exact)) > 1e-5


def test_tf32_rounding_matches_rna():
    """``_tf32`` keeps 10 mantissa bits, rounding half away from zero."""
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -11), 1.0 + 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 * 2 ** -10, -(1.0 + 2 ** -10), 1.0])
    assert torch.equal(_tf32(x), want)
    big = _tf32(x)
    assert torch.equal(big.view(torch.int32) & 0x1FFF, torch.zeros(5, dtype=torch.int32))
