"""Port WKV6 (CPU path = its plain version) vs the JAX package: the port's
``wkv6_ref`` and ``ops.wkv6`` against the JAX oracle and the JAX Pallas
kernel in interpret mode on the JAX test's cases (tests/test_kernels_rwkv.py)
x {slow, fast, faster} decay at its 2e-3, state chaining through ``s0``, the
port's ``wkv_chunked`` against the JAX one, and the chunk contract (a
ragged length raises unless ``ragged=True``). ``wkv6_subchunk_ref``
(``tests/wkv6_rehearsal.py``), the CUDA kernel's arithmetic (sub-chunks of
16, reference points, 3xTF32) in plain torch, is held against the same
oracles, at decays that underflow to 0 or sit at the kernel's -60 floor on
log w, and from a state with a ragged last chunk."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv_scan.ops import wkv6 as jax_wkv6  # noqa: E402
from repro.kernels.rwkv_scan.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from wkv6_rehearsal import _mm3, _tf32, wkv6_subchunk_ref  # noqa: E402

CASES = [
    # (b, s, h, dk, dv, chunk)
    (2, 128, 3, 16, 16, 32),
    (1, 64, 2, 64, 64, 16),
    (2, 256, 4, 32, 32, 64),
    (1, 96, 1, 8, 8, 32),   # 96 % 32 == 0
    (3, 32, 2, 16, 16, 32),  # chunk == seq
]
# w = sigmoid(z) * span + low: the JAX test's slow and fast regimes, and a
# faster one with decays down to 0.05
REGIMES = {"slow": (0.1, 0.88), "fast": (0.5, 0.15), "faster": (0.9, 0.05)}
TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(b, s, h, dk, dv, regime, seed=0):
    g = np.random.default_rng(seed)
    r = g.standard_normal((b, s, h, dk), dtype=np.float32)
    k = g.standard_normal((b, s, h, dk), dtype=np.float32)
    v = g.standard_normal((b, s, h, dv), dtype=np.float32)
    span, low = REGIMES[regime]
    z = g.standard_normal((b, s, h, dk), dtype=np.float32)
    w = (1.0 / (1.0 + np.exp(-z)) * span + low).astype(np.float32)
    u = (g.standard_normal((h, dk), dtype=np.float32) * 0.1).astype(np.float32)
    return r, k, v, w, u


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("regime", ["slow", "fast", "faster"])
def test_wkv6_vs_jax_oracle_and_interpret_kernel(case, regime):
    b, s, h, dk, dv, chunk = case
    arrays = _inputs(b, s, h, dk, dv, regime, seed=CASES.index(case))
    o_ref, s_ref = wkv6_ref(*_t(arrays))
    o, sf = ops.wkv6(*_t(arrays), chunk=chunk)
    o_sub, s_sub = wkv6_subchunk_ref(*_t(arrays), chunk=chunk)
    assert o.dtype == sf.dtype == o_sub.dtype == torch.float32
    assert o.shape == o_sub.shape == (b, s, h, dv) and sf.shape == s_sub.shape == (b, h, dk, dv)
    assert torch.isfinite(o_sub).all() and torch.isfinite(s_sub).all()
    jo, js = jax_wkv6_ref(*_j(arrays))
    ko, ks = jax_wkv6(*_j(arrays), chunk=chunk, interpret=True)
    for ours in (o_ref, o, o_sub):
        np.testing.assert_allclose(ours.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ko), **TOL)
    for ours in (s_ref, sf, s_sub):
        np.testing.assert_allclose(ours.numpy(), np.asarray(js), **TOL)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ks), **TOL)


def test_wkv6_faster_decay_is_finite_and_matches():
    """Decays down to 0.05: the plain path stays finite and on the oracle."""
    arrays = _inputs(1, 128, 2, 64, 64, "faster", seed=7)
    o, sf = ops.wkv6(*_t(arrays), chunk=64)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    jo, js = jax_wkv6_ref(*_j(arrays))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **TOL)


def test_wkv6_state_chains_across_calls():
    """Splitting a sequence across two oracle calls (state carried through
    ``s0``) matches one full-sequence call, on both sides."""
    arrays = _inputs(1, 128, 2, 16, 16, "fast", seed=9)
    r, k, v, w, u = _t(arrays)
    o_full, s_full = ops.wkv6(r, k, v, w, u, chunk=32)
    o1, s1 = wkv6_ref(r[:, :64], k[:, :64], v[:, :64], w[:, :64], u)
    o2, s2 = wkv6_ref(r[:, 64:], k[:, 64:], v[:, 64:], w[:, 64:], u, s0=s1)
    np.testing.assert_allclose(s_full.numpy(), s2.numpy(), **TOL)
    np.testing.assert_allclose(o_full.numpy(), torch.cat([o1, o2], 1).numpy(), **TOL)
    jr, jk, jv, jw, ju = _j(arrays)
    _, js1 = jax_wkv6_ref(jr[:, :64], jk[:, :64], jv[:, :64], jw[:, :64], ju)
    jo2, js2 = jax_wkv6_ref(jr[:, 64:], jk[:, 64:], jv[:, 64:], jw[:, 64:], ju, s0=js1)
    np.testing.assert_allclose(o2.numpy(), np.asarray(jo2), **TOL)
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), **TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[4]])
@pytest.mark.parametrize("regime", ["slow", "faster"])
def test_wkv_chunked_matches_jax(case, regime):
    b, s, h, dk, dv, chunk = case
    arrays = _inputs(b, s, h, dk, dv, regime, seed=3)
    o, sf = rwkv.wkv_chunked(*_t(arrays), chunk=chunk)
    jo, js = jax_rwkv.wkv_chunked(*_j(arrays), chunk=chunk)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **TOL)


def test_wkv6_rejects_ragged_length():
    """As the Pallas wrapper does: a chunk that does not divide raises."""
    r, k, v, w, u = _t(_inputs(1, 100, 2, 16, 16, "slow"))
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w, u, chunk=64)
    with pytest.raises(ValueError):
        jax_wkv6(*_j([t.numpy() for t in (r, k, v, w, u)]), chunk=64, interpret=True)


@pytest.mark.parametrize("s,chunk", [(100, 64), (13, 8), (1, 64)])
def test_wkv6_ragged_from_a_state_matches_jax(s, chunk):
    """``ragged=True`` takes a shorter last chunk and ``s0`` a starting
    state (the model's prefill at any length, and a decode step): the JAX
    oracle from the same state gives the same answer."""
    arrays = _inputs(2, s, 2, 16, 16, "fast", seed=s)
    s0 = np.random.default_rng(5).standard_normal((2, 2, 16, 16)).astype(np.float32)
    o, sf = ops.wkv6(*_t(arrays), chunk=chunk, s0=torch.from_numpy(s0), ragged=True)
    jo, js = jax_wkv6_ref(*_j(arrays), s0=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **TOL)
    o, sf = ops.wkv6(*_t(arrays), chunk=chunk, ragged=True)
    jo, js = jax_wkv6_ref(*_j(arrays))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **TOL)


def test_chunk_longer_than_sequence():
    """``ops.wkv6`` cuts the chunk to the sequence; ``wkv_chunked``, as in
    JAX, takes the step-by-step path for a length its chunk does not
    divide. All three give the oracle's answer."""
    arrays = _inputs(2, 16, 2, 16, 16, "fast", seed=4)
    o_ref, s_ref = wkv6_ref(*_t(arrays))
    for o, sf in (ops.wkv6(*_t(arrays), chunk=64), rwkv.wkv_chunked(*_t(arrays), chunk=64),
                  rwkv.wkv_chunked(*_t(arrays), chunk=12)):
        np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(sf.numpy(), s_ref.numpy(), rtol=1e-6, atol=1e-6)


def test_wkv6_refuses_other_dtypes_and_shapes():
    r, k, v, w, u = _t(_inputs(1, 16, 2, 16, 16, "slow"))
    with pytest.raises(TypeError):
        ops.wkv6(r.bfloat16(), k, v, w, u)
    with pytest.raises(TypeError):
        ops.wkv6(r, k, v, w, u.bfloat16())
    with pytest.raises(ValueError):
        ops.wkv6(r, k[:, :, :1], v, w, u)
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w, u[:1])
    with pytest.raises(TypeError):
        ops.wkv6(r, k, v, w, u, s0=torch.zeros(1, 2, 16, 16, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.wkv6(r, k, v, w, u, s0=torch.zeros(1, 2, 16, 8))


@pytest.mark.parametrize("low", [0.0, 1e-30])
def test_wkv6_subchunk_ref_decay_underflow_and_floor(low):
    """Decays that underflowed to 0 (log w = -inf) and decays below the
    kernel's e^-60 floor in half the channels, ordinary ones in the rest:
    finite, and on the oracle."""
    r, k, v, w, u = _inputs(1, 80, 2, 16, 16, "fast", seed=11)
    w[..., ::2] = low
    o, sf = wkv6_subchunk_ref(*_t((r, k, v, w, u)), chunk=64)
    assert torch.isfinite(o).all() and torch.isfinite(sf).all()
    jo, js = jax_wkv6_ref(*_j((r, k, v, w, u)))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **TOL)


@pytest.mark.parametrize("s,chunk", [(100, 64), (13, 8), (70, 24)])
def test_wkv6_subchunk_ref_ragged_from_a_state(s, chunk):
    """A last chunk shorter than the rest, and chunks that are not a
    multiple of 16 rows, from a given state: the JAX oracle from the same
    state gives the same answer."""
    arrays = _inputs(2, s, 2, 32, 32, "faster", seed=s)
    s0 = np.random.default_rng(6).standard_normal((2, 2, 32, 32)).astype(np.float32)
    o, sf = wkv6_subchunk_ref(*_t(arrays), chunk=chunk, s0=torch.from_numpy(s0))
    jo, js = jax_wkv6_ref(*_j(arrays), s0=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(sf.numpy(), np.asarray(js), **TOL)


def test_tf32_split_keeps_fp32_accuracy():
    """TF32 rounds to nearest with ties away from zero on a 10-bit
    mantissa; one TF32 product is off by ~1e-3 relative, the 3xTF32 split
    by fp32's own rounding."""
    one = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12, 3.0], dtype=torch.float32)
    assert _tf32(one).tolist() == [1 + 2.0**-10, -(1 + 2.0**-10), 1.0, 3.0]
    g = np.random.default_rng(2)
    a = torch.from_numpy(g.standard_normal((16, 64), dtype=np.float32))
    b = torch.from_numpy(g.standard_normal((64, 24), dtype=np.float32))
    exact = a.double() @ b.double()
    scale = exact.abs().max().item()
    err3 = (_mm3(a, b).double() - exact).abs().max().item() / scale
    err1 = ((_tf32(a) @ _tf32(b)).double() - exact).abs().max().item() / scale
    assert err3 < 1e-6 < 1e-4 < err1


@pytest.mark.parametrize("regime", ["slow", "fast", "faster"])
def test_wkv6_subchunk_ref_keeps_fp32_accuracy(regime):
    """The kernel's arithmetic (reference points, running decay products,
    3xTF32) stays as close to a float64 recurrence as plain fp32 does:
    within 5e-6 relative Frobenius, outputs and state."""
    arrays = _inputs(1, 256, 2, 64, 64, regime, seed=12)
    o64, s64 = wkv6_ref(*[torch.from_numpy(a).double() for a in arrays])
    o, sf = wkv6_subchunk_ref(*_t(arrays), chunk=64)
    for ours, exact in ((o, o64), (sf, s64)):
        assert ((ours.double() - exact).norm() / exact.norm()).item() < 5e-6
