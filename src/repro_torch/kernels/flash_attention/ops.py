"""Public flash-attention wrapper in the model layout ``(b, s, h, d)``,
dispatching on the tensors' device. CPU tensors take the plain version
(``ref.attention_ref``); CUDA tensors launch a hand-written kernel
(``csrc/flash_attention.cu``) or raise on a dtype, head size or layout it
does not take.

The kernel's route is chosen by dtype and head size alone (``route``),
never because another route failed:

* ``"wgmma"`` — bf16 with d in 64, 128 or 256: the tensor-core kernel,
  which loads q/k/v by TMA. The wrapper computes each tensor map's
  geometry (``_geometry``) and raises ``ValueError`` on a view TMA
  cannot read: a base that is not 16-byte aligned, or a batch, sequence
  or head stride that is not a multiple of 16 bytes.
* ``"simt"`` — fp32 at any supported d (its 2e-5 parity rules out TF32
  and bf16 products; the backward's 3xTF32 route is not used here), and
  bf16 with d 16 or 32 (narrower than the 128-byte swizzle): the SIMT fp32
  kernel, which reads any strides.

Both read q/k/v through their batch/sequence/head strides, so the
``(b, s, h, d)`` views go in as they are (no transpose, no
``.contiguous()``); only the last dimension must be contiguous. The
output is a new contiguous ``(b, s_q, hq, d)`` tensor.

``block_q``/``block_k`` keep the JAX wrapper's contract — sequence
lengths must divide them, else ``ValueError`` — on both paths. The CUDA
kernels tile by 64 x 64 internally whatever they are.

Under autograd (grad enabled and q, k or v requiring grad) a CUDA call
goes through ``FlashAttentionFunction``: the forward kernel also writes
each row's log-sum-exp, and the backward is the hand-written kernel
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``), which is also
public, with the plain ``ref.attention_bwd_ref`` on the CPU. Its route,
again by dtype and head size alone, is ``bwd_route``'s:

* ``"wgmma"`` — bf16 with d in 64, 128 or 256, as the forward;
* ``"mma_tf32"`` — fp32 with d in 64, 128 or 256: tensor-core kernels
  whose products are 3xTF32 ``mma.sync`` (two TF32 parts an operand),
  which hold fp32 accuracy (1e-5); the fp32 forward stays SIMT;
* ``"simt"`` — d 16 or 32 (smoke widths only), fp32 or bf16: the SIMT
  fp32 kernels.

Both tensor-core routes run on the launch plan ``bwd_plan`` computes,
which spreads a kv head's key tiles over enough blocks to fill the card.

``flash_attention.launches`` and ``flash_attention_bwd.launches`` count
kernel launches (never plain-version calls). A fake tensor (the dry
run's) takes the kernels' path up to the launch, then returns the
outputs' shapes (the forward's LSE too) and charges ``cost``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
WGMMA_HEAD_DIMS = (64, 128, 256)
# a TMA box: 64 columns of d (128 bytes of bf16, the swizzle's width), one
# head, 64 sequence rows, one batch entry
TMA_BOX = (64, 1, 64, 1)
TMA_ALIGN = 16  # bytes: the base address and every stride


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The forward's route: ``"wgmma"`` (bf16 tensor-core kernel) or
    ``"simt"`` (fp32 SIMT kernel), by dtype and head size only."""
    if dtype == torch.bfloat16 and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "simt"


def bwd_route(dtype: torch.dtype, head_dim: int) -> str:
    """The backward's route, by dtype and head size only: ``"wgmma"``
    (bf16) or ``"mma_tf32"`` (fp32, 3xTF32 products) at d 64/128/256,
    where both tensor-core routes run on ``bwd_plan``; ``"simt"``
    otherwise."""
    if head_dim in WGMMA_HEAD_DIMS:
        return "wgmma" if dtype == torch.bfloat16 else "mma_tf32"
    return "simt"


class TmaGeometry(NamedTuple):
    dims: tuple  # (d, h, s, b): innermost first
    strides: tuple  # bytes, of h, s and b
    box: tuple


def _check_base(data_ptr: int) -> None:
    if data_ptr % TMA_ALIGN:
        raise ValueError(f"TMA needs a {TMA_ALIGN}-byte aligned base, got {data_ptr:#x}")


@functools.lru_cache(maxsize=1024)
def _geometry(shape: tuple, strides: tuple, element_size: int) -> TmaGeometry:
    b, s, h, d = shape
    if strides[3] != 1:
        raise ValueError("TMA needs a contiguous last dimension")
    byte_strides = []
    inner = d * element_size  # extent of the dimensions inside this one
    for size, stride in ((h, strides[2]), (s, strides[1]), (b, strides[0])):
        st = stride * element_size if size > 1 else inner
        byte_strides.append(st)
        inner = st * size
    for name, st in zip(("head", "sequence", "batch"), byte_strides):
        if st % TMA_ALIGN:
            raise ValueError(f"TMA needs {name} strides in multiples of {TMA_ALIGN} bytes, got {st}")
    return TmaGeometry((d, h, s, b), tuple(byte_strides), TMA_BOX)


def _tma_args(*tensors: torch.Tensor):
    """The tensors' geometry as the C entry points take it: 11 unsigned
    64-bit values a tensor (dims, byte strides, box)."""
    args = []
    for t in tensors:
        _check_base(t.data_ptr())
        args += [t.shape, t.stride()]
    return _packed(*args, tensors[0].element_size())


@functools.lru_cache(maxsize=256)
def _packed(*shapes_strides_size):
    """Shared between launches of the same shapes and strides (the
    pointers go to the C entry point apart); never written."""
    *pairs, element_size = shapes_strides_size
    vals = []
    for shape, strides in zip(pairs[::2], pairs[1::2]):
        g = _geometry(tuple(shape), tuple(strides), element_size)
        vals.extend((*g.dims, *g.strides, *g.box))
    return (ctypes.c_ulonglong * len(vals))(*vals)


# the backward's tensor-core launch plan (csrc/flash_attention_bwd.cu)
BWD_TILE = 64  # queries or keys a tile
BWD_MIN_BLOCKS = 128  # dK/dV blocks wanted: about one a streaming multiprocessor


class BwdPlan(NamedTuple):
    key_tiles: int
    query_tiles: int
    paired: bool  # a dK/dV block takes key tiles p and key_tiles - 1 - p
    splits: int  # dK/dV blocks a GQA group's query heads are spread over
    dkdv_blocks: int
    dq_blocks: int
    scratch_bytes: int  # fp32 partial dK and dV, (2, splits, b, sk, hkv, d)


@functools.lru_cache(maxsize=256)
def bwd_plan(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, causal: bool = True) -> BwdPlan:
    """The tensor-core backward's launch plan. Under the causal mask a key
    tile ``p`` is seen by about ``n - p`` query tiles, so a dK/dV block
    takes tiles ``p`` and ``n - 1 - p`` and every block walks about
    ``n + 1``. Where ``b x hkv x`` those blocks are fewer than
    ``BWD_MIN_BLOCKS`` (MQA: one kv head), the group's query heads are
    split over the smallest divisor of ``hq / hkv`` that reaches it; each
    split writes fp32 partial dK and dV, summed in split order by a second
    kernel. dQ takes a block per (query tile, query head, batch)."""
    n_kt = -(-sk // BWD_TILE)
    n_qt = -(-sq // BWD_TILE)
    n_rep = hq // hkv
    per_split = b * hkv * (-(-n_kt // 2) if causal else n_kt)
    splits = next((s for s in range(1, n_rep + 1)
                   if n_rep % s == 0 and per_split * s >= BWD_MIN_BLOCKS), n_rep)
    scratch = 2 * splits * b * sk * hkv * d * 4 if splits > 1 else 0
    return BwdPlan(n_kt, n_qt, causal, splits, per_split * splits, n_qt * hq * b, scratch)


@functools.lru_cache(maxsize=1024)
def pairs(sq: int, sk: int, causal: bool = True, window: Optional[int] = None,
          q_offset: int = 0) -> int:
    """The (query, key) pairs the mask lets through: query ``i`` at
    position ``i + q_offset`` sees keys up to it (causal) and after it less
    ``window``."""
    n = 0
    for p in range(q_offset, q_offset + sq):
        hi = min(sk - 1, p) if causal else sk - 1
        n += max(0, hi - (max(0, p - window + 1) if window else 0) + 1)
    return n


def cost(b: int, sq: int, sk: int, hq: int, hkv: int, d: int, itemsize: int, *,
         causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
         backward: bool = False) -> Tuple[float, float]:
    """``(operations, bytes)`` of one call on the pairs the mask needs: the
    forward's two products (S, PV) of 2 d multiply-adds a pair and head,
    q, k, v read and o written once; the backward's five (S, dP, dV, dK,
    dQ), q, o, dO, k, v and the LSE read and dq, dk, dv written once. The
    forward's LSE (4 bytes a row, training only) is left out."""
    n = b * hq * d * pairs(sq, sk, causal, window, q_offset)
    if backward:
        return (10.0 * n, itemsize * (4.0 * b * sq * hq * d + 4 * b * sk * hkv * d)
                + 4 * b * hq * sq)
    return 4.0 * n, itemsize * (2.0 * b * sq * hq * d + 2 * b * sk * hkv * d)


def flash_attention(
    q: torch.Tensor,  # (b, s_q, hq, d)
    k: torch.Tensor,  # (b, s_k, hkv, d)
    v: torch.Tensor,  # (b, s_k, hkv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    block_q: int = 128,
    block_k: int = 128,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq ({sq},{sk}) must divide blocks ({bq},{bk})")
    if not _build.takes_kernel(q, "flash_attention"):
        return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    device = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if t.dim() != 4 or t.shape[-1] != d:
            raise ValueError(f"{name} must be (b, s, h, {d}), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: last dimension must be contiguous")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not supported; kernel takes {HEAD_DIMS}")
    if k.shape[0] != b or v.shape[:3] != k.shape[:3] or hq % hkv:
        raise ValueError("k/v must be (b, s_k, hkv, d) with hq divisible by hkv")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, want_lse=False)[0]


def _forward(q, k, v, causal, window, q_offset, want_lse):
    """Launch the forward kernel on checked CUDA tensors; returns ``(out,
    lse or None)``."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    device = q.device
    out = torch.empty((b, sq, hq, d), dtype=q.dtype, device=device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=device) if want_lse else None
    if _build.fake(q):
        return _build.charge(flash_attention, cost(b, sq, sk, hq, hkv, d, q.element_size(),
                                                   causal=causal, window=window,
                                                   q_offset=q_offset), (out, lse))
    tma = _tma_args(q, k, v) if route(q.dtype, d) == "wgmma" else None
    if out.numel() == 0:
        return out, lse
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    err = _build.library().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, sk, hq, hkv, d,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2],
        1.0 / math.sqrt(d),
        int(causal),
        int(window or 0),
        int(q_offset),
        _build.DTYPE_CODES[q.dtype],
        tma,
        None if lse is None else lse.data_ptr(),
        device.index,
        _build.current_stream(device.index),
    )
    _build.check(err, "flash_attention_fwd")
    _build.count_launch(flash_attention)
    return out, lse


flash_attention.launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """The forward kernel with its backward kernel. Saves ``(q, k, v, out,
    lse)``; the backward reads the stream current on its own thread."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _forward(q, k, v, causal, window, q_offset, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            dout, q, k, v, out, lse, causal=causal, window=window, q_offset=q_offset
        )
        return dq, dk, dv, None, None, None


def flash_attention_bwd(
    dout: torch.Tensor,  # (b, s_q, hq, d)
    q: torch.Tensor,
    k: torch.Tensor,  # (b, s_k, hkv, d)
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # (b, hq, s_q) fp32, the forward's log-sum-exp
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` in the inputs' dtype. A CPU tensor takes
    ``ref.attention_bwd_ref``; a CUDA tensor launches the backward kernels
    of its ``bwd_route`` (D = rowsum(dO O), dK/dV, the sum of the splits'
    partials where ``bwd_plan`` splits, dQ) on contiguous copies of any
    strided input."""
    if not _build.takes_kernel(q, "flash_attention_bwd"):
        return attention_bwd_ref(
            dout, q, k, v, out, lse, causal=causal, window=window, q_offset=q_offset
        )
    device = q.device
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    q, k, v, out, dout = (t.contiguous() for t in (q, k, v, out, dout))
    for name, t, shape in (("k", k, (b, sk, hkv, d)), ("v", v, (b, sk, hkv, d)),
                           ("out", out, (b, sq, hq, d)), ("dout", dout, (b, sq, hq, d))):
        if t.device != device or t.dtype != q.dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {q.dtype} {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dtype {q.dtype} not supported (float32, bfloat16)")
    if d not in HEAD_DIMS or hq % hkv:
        raise ValueError(f"head_dim {d} (kernel takes {HEAD_DIMS}) or heads {hq}/{hkv}")
    if lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, sq) or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 ({b}, {hq}, {sq})")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if _build.fake(q):
        return _build.charge(flash_attention_bwd, cost(
            b, sq, sk, hq, hkv, d, q.element_size(), causal=causal, window=window,
            q_offset=q_offset, backward=True), (dq, dk, dv))
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    tma, part, plan = None, None, None
    kernels = bwd_route(q.dtype, d)
    if kernels != "simt":
        if kernels == "wgmma":
            tma = _tma_args(q, k, v, dout)
        plan = bwd_plan(b, sq, sk, hq, hkv, d, bool(causal))
        # each 64-query tile's lse (log2 units for wgmma) and D, padded
        dvec = torch.empty((b, hq, plan.query_tiles, 2, BWD_TILE), dtype=torch.float32,
                           device=device)
        if plan.scratch_bytes:
            part = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32, device=device)
    else:
        dvec = torch.empty((b, hq, sq), dtype=torch.float32, device=device)
    err = _build.library().flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dvec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, sk, hq, hkv, d, 1.0 / math.sqrt(d), int(causal), int(window or 0),
        int(q_offset), _build.DTYPE_CODES[q.dtype], tma,
        None if part is None else part.data_ptr(),
        plan.splits if plan else 1, int(plan.paired) if plan else 0, device.index,
        _build.current_stream(device.index),
    )
    _build.check(err, "flash_attention_bwd")
    _build.count_launch(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0
