"""Port WKV6 (CPU path = its plain version) vs the JAX package: the port's
``wkv6_ref`` and ``ops.wkv6`` against the JAX oracle and the JAX Pallas
kernel in interpret mode on the JAX test's cases (tests/test_kernels_rwkv.py)
x {slow, fast, faster} decay at its 2e-3, state chaining through ``s0``, the
port's ``wkv_chunked`` against the JAX one, and the chunk contract (a
ragged length raises unless ``ragged=True``). ``wkv6_subchunk_ref``
(``tests/wkv6_rehearsal.py``), the CUDA kernel's arithmetic (sub-chunks of
16, reference points, 3xTF32) in plain torch, is held against the same
oracles, at decays that underflow to 0 or sit at the kernel's -60 floor on
log w, and from a state with a ragged last chunk.

The backward: autograd through the port's ``wkv6_ref`` (``ops.wkv6_bwd``'s
CPU path, the backward kernel's plain version) against ``jax.vjp`` of the
JAX oracle, with cotangents on the output and the final state, with and
without ``s0``; ``wkv6_bwd_chunked`` (``tests/wkv6_bwd_rehearsal.py``),
the backward kernel's arithmetic (boundary states and cotangents by the
chunk's closed form, every chunk from them by the step recurrences),
against that plain version, its boundary states against the plain
forward's; and
``WKV6Function``'s gradients with its kernels replaced by the plain
versions."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_cores import share_cores  # noqa: E402

share_cores()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.rwkv_scan.ops import wkv6 as jax_wkv6  # noqa: E402
from repro.kernels.rwkv_scan.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.models import rwkv as jax_rwkv  # noqa: E402
from repro_torch.kernels.rwkv_scan import ops  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import rwkv  # noqa: E402
from repro_torch.kernels.rwkv_scan.ref import wkv6_bwd_ref  # noqa: E402
from wkv6_bwd_rehearsal import CHUNK, COLS, SEG, _boundaries, wkv6_bwd_chunked  # noqa: E402
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


# ---------------------------------------------------------------------------
# the backward (B3's plain version and its arithmetic)
# ---------------------------------------------------------------------------

BWD_REL = 1e-5  # relative Frobenius, each gradient (chip_smoke.BWD_TOL's fp32)
GRADS = ("dr", "dk", "dv", "dw", "du", "ds0")


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _cotangents(b, s, h, dk, dv, seed, with_s0):
    g = np.random.default_rng(seed)
    s0 = g.standard_normal((b, h, dk, dv), dtype=np.float32) if with_s0 else None
    do = g.standard_normal((b, s, h, dv), dtype=np.float32)
    ds = g.standard_normal((b, h, dk, dv), dtype=np.float32)
    return s0, do, ds


@jax.jit
def _jax_vjp(r, k, v, w, u, s0, do, ds):
    _, pull = jax.vjp(jax_wkv6_ref, r, k, v, w, u, s0)
    return pull((do, ds))


@jax.jit
def _jax_vjp_zero_state(r, k, v, w, u, do, ds):
    _, pull = jax.vjp(lambda *a: jax_wkv6_ref(*a), r, k, v, w, u)
    return pull((do, ds))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("regime", ["slow", "fast", "faster"])
@pytest.mark.parametrize("with_s0", [False, True])
def test_wkv6_bwd_ref_vs_jax_vjp(case, regime, with_s0):
    """Every gradient of ``(o, final state)`` under cotangents on both,
    within 1e-5 relative Frobenius and the forward's 2e-3 of JAX's."""
    b, s, h, dk, dv, _ = case
    arrays = _inputs(b, s, h, dk, dv, regime, seed=CASES.index(case))
    s0, do, ds = _cotangents(b, s, h, dk, dv, 50 + CASES.index(case), with_s0)
    ours = ops.wkv6_bwd(torch.from_numpy(do), torch.from_numpy(ds), *_t(arrays),
                        s0=None if s0 is None else torch.from_numpy(s0))
    if with_s0:
        theirs = _jax_vjp(*_j(arrays), jnp.asarray(s0), jnp.asarray(do), jnp.asarray(ds))
    else:
        theirs = (*_jax_vjp_zero_state(*_j(arrays), jnp.asarray(do), jnp.asarray(ds)), None)
        assert ours[5] is None
    for name, a, want in zip(GRADS, ours, theirs):
        if want is None:
            continue
        a = a.numpy()
        assert np.isfinite(a).all(), name
        assert _rel(a, want) <= BWD_REL, (name, _rel(a, want))
        np.testing.assert_allclose(a, np.asarray(want), **TOL, err_msg=name)


def _bwd_inputs(b, s, h, dk, dv, regime, seed, with_s0, low=None):
    r, k, v, w, u = _inputs(b, s, h, dk, dv, regime, seed=seed)
    if low is not None:
        w[..., ::2] = low
    s0, do, ds = _cotangents(b, s, h, dk, dv, seed + 1, with_s0)
    tensors = [torch.from_numpy(x) for x in (do, ds, r, k, v, w, u)]
    return (*tensors, None if s0 is None else torch.from_numpy(s0))


@pytest.mark.parametrize(
    "b,s,h,dk,dv,regime,with_s0,low",
    [
        (1, 40, 2, 64, 64, "slow", True, None),  # two chunks, the last ragged
        (2, 37, 3, 16, 16, "fast", True, None),
        (1, 33, 2, 8, 8, "slow", False, None),  # one lane a row
        (1, 21, 2, 64, 8, "fast", True, None),
        (1, 48, 2, 16, 32, "faster", False, None),
        (1, 35, 2, 16, 16, "fast", True, 0.0),  # decays that underflowed to 0
        (1, 35, 2, 16, 16, "fast", False, 1e-30),  # below K4's e^-60 floor
        (1, 5, 2, 16, 16, "slow", True, None),  # shorter than one segment
        (1, 150, 2, 64, 64, "slow", True, None),  # five chunks, a ragged tail, from s0
        (2, 200, 2, 16, 16, "faster", True, None),  # seven chunks, a ragged tail, from s0
    ],
)
def test_wkv6_bwd_rehearsal_matches_the_plain_backward(b, s, h, dk, dv, regime, with_s0, low):
    """The backward kernel's boundary states and cotangents, its chunks'
    checkpoints and recompute, the ``dw`` product and the sum orders give
    the plain version's gradients within 1e-5, all finite."""
    args = _bwd_inputs(b, s, h, dk, dv, regime, seed=s + dk, with_s0=with_s0, low=low)
    got = wkv6_bwd_chunked(*args)
    want = wkv6_bwd_ref(*args)
    for name, a, ref in zip(GRADS, got, want):
        if ref is None:
            assert a is None
            continue
        assert torch.isfinite(a).all(), name
        assert _rel(a, ref) <= BWD_REL, (name, _rel(a, ref))


def test_wkv6_bwd_rehearsal_is_finite_in_the_faster_regime_and_one_cotangent():
    """Decays down to 0.05 over 200 steps, only the final state's cotangent
    (a state carried to the next call) or only the output's."""
    args = list(_bwd_inputs(1, 200, 2, 32, 32, "faster", seed=3, with_s0=True))
    for drop in (0, 1):
        one = list(args)
        one[drop] = None
        got = wkv6_bwd_chunked(*one)
        want = wkv6_bwd_ref(*one)
        for name, a, ref in zip(GRADS, got, want):
            assert torch.isfinite(a).all(), name
            assert _rel(a, ref) <= BWD_REL, (drop, name, _rel(a, ref))


def test_wkv6_bwd_rehearsal_constants_match_the_source():
    src = (ops._build.CSRC / "wkv6_bwd.cu").read_text()
    assert f"constexpr int kChunk = {CHUNK};" in src
    assert f"constexpr int kSeg = {SEG};" in src
    assert f"constexpr int kCols = {COLS};" in src


@pytest.mark.parametrize("regime,low", [("slow", None), ("faster", None), ("fast", 0.0)])
def test_wkv6_bwd_rehearsal_boundary_states_match_the_forward(regime, low):
    """Pass A's states at every chunk's start, by the closed form with K4's
    floor on log w, equal the plain forward's final state over each prefix
    within 1e-6 relative Frobenius, decays of 0 included."""
    r, k, v, w, u = _inputs(1, 3 * CHUNK + 7, 2, 16, 16, regime, seed=21)
    if low is not None:
        w[..., ::2] = low
    s0 = np.random.default_rng(22).standard_normal((1, 2, 16, 16)).astype(np.float32)
    rt, kt, vt, wt, ut, st = _t((r, k, v, w, u, s0))
    states, last = _boundaries(*(x.permute(0, 2, 1, 3) for x in (kt, vt, wt)), st, False)
    for n, got in enumerate([*states[1:], last]):
        end = min(r.shape[1], (n + 1) * CHUNK)
        _, want = wkv6_ref(rt[:, :end], kt[:, :end], vt[:, :end], wt[:, :end], ut, st)
        assert _rel(got, want) <= 1e-6, (n, _rel(got, want))


@pytest.mark.parametrize("need", [(0, 1, 2, 3, 4, 5), (0, 3), (5,), (1, 4)])
@pytest.mark.parametrize("use_state", [True, False])
def test_wkv6_function_gradients_with_plain_kernels(monkeypatch, need, use_state):
    """``WKV6Function`` with its forward launch replaced by the plain
    forward (its backward takes the plain backward on CPU tensors): the
    gradients of the inputs that require them equal autograd through
    ``wkv6_ref``, a final state the loss never reads included."""
    monkeypatch.setattr(ops, "_forward", lambda r, k, v, w, u, chunk, s0, tile: wkv6_ref(
        r.detach(), k.detach(), v.detach(), w.detach(), u.detach(),
        None if s0 is None else s0.detach()))
    co, cs, *leaves = _bwd_inputs(2, 21, 2, 16, 16, "fast", seed=4, with_s0=True)
    grads = []
    for apply in (lambda *a: ops.WKV6Function.apply(*a, 8, 0), wkv6_ref):
        ins = [t.clone().requires_grad_(i in need) for i, t in enumerate(leaves)]
        o, sf = apply(*ins)
        loss = (o * co).sum() + ((sf * cs).sum() if use_state else 0)
        grads.append(torch.autograd.grad(loss, [t for t in ins if t.requires_grad]))
    for a, want in zip(*grads):
        assert _rel(a.detach(), want) <= BWD_REL
