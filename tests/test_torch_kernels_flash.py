"""Port flash attention (CPU path = its plain version) vs the JAX package:
the jnp oracle on the JAX test's cases (tests/test_kernels_flash.py) at its
tolerances, the Pallas kernel in interpret mode on two of them, the
q_offset suffix, the ragged rejection and a fully-masked row."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
