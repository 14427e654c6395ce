"""The WKV6 backward kernel's arithmetic (``src/repro_torch/csrc/wkv6_bwd.cu``)
rehearsed in plain torch on the CPU, for ``tests/test_torch_kernels_rwkv.py``.
``wkv6_bwd_chunked`` walks the kernel's three passes, vectorised over batch,
head and row:

- A and B: the state at every chunk's start (first chunk to last, from
  ``s0``) and the cotangent at every chunk's end (last to first, from
  ``dS_T``) by the chunk's closed form, with K4's clamps (log w floored at
  -60, in log2 units; every exponent a non-positive difference clamped at
  0) and its 3xTF32 products;
- C: each chunk from its boundary state and cotangent, the state
  checkpointed every ``SEG`` steps by a forward walk, then the segments
  last to first, the states recomputed and the cotangent walked back:
  ``dw`` as the product of the two, no division, no logarithm;
- the sums in the kernel's orders: each thread's 8 columns in order, a
  row's column groups and a warp's rows by the shuffle trees, the warps'
  ``dv`` parts in warp order; ``du``, a chunk's part over its segments
  last to first (each segment's steps in order), the parts in (batch,
  chunk) order."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from wkv6_rehearsal import LOG2_FLOOR, W_FLOOR, _decay2, _mm3

CHUNK = 32  # steps a chunk (kChunk)
SEG = 4  # steps a pass C segment (kSeg)
COLS = 8  # state columns a pass C thread (kCols)


def _tree(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension as xor shuffles from the top bit do it:
    pairs half the length apart first."""
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _in_order(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last dimension left to right (one thread's loop)."""
    acc = x[..., 0]
    for i in range(1, x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _boundaries(p, q, w, init, reverse):
    """Passes A (``reverse`` False: p = k, q = v, from s0) and B (p = r,
    q = do, from dS_T): the value at each chunk's start (A) or end (B),
    by the closed form. Inputs (b, h, s, d); returns a list a chunk of
    (b, h, dk, dv) and the value past the last chunk walked."""
    s = p.shape[2]
    starts = list(range(0, s, CHUNK))
    out = [None] * len(starts)
    x = init
    for n in (reversed(range(len(starts))) if reverse else range(len(starts))):
        t0 = starts[n]
        pc, qc, wc = (a[:, :, t0:t0 + CHUNK] for a in (p, q, w))
        cum = torch.cumsum(torch.clamp(torch.log2(torch.clamp(wc, min=W_FLOOR)), min=LOG2_FLOOR),
                           dim=2)
        last = cum[:, :, -1:]
        if reverse:  # r back to the chunk's start: e^{cum_prev}
            prev = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
            pd = pc * _decay2(prev)
        else:  # k to the chunk's end: e^{cum_last - cum}
            pd = pc * _decay2(last - cum)
        out[n] = x
        x = _decay2(last).transpose(-1, -2) * x + _mm3(pd.transpose(-1, -2), qc)
    return out, x


def wkv6_bwd_chunked(
    do: Optional[torch.Tensor],  # (b, s, h, dv), or None
    dstate: Optional[torch.Tensor],  # (b, h, dk, dv), or None
    r: torch.Tensor,  # (b, s, h, dk) fp32
    k: torch.Tensor,
    v: torch.Tensor,  # (b, s, h, dv)
    w: torch.Tensor,  # (b, s, h, dk)
    u: torch.Tensor,  # (h, dk)
    s0: Optional[torch.Tensor] = None,  # (b, h, dk, dv)
) -> Tuple[Optional[torch.Tensor], ...]:
    """``(dr, dk, dv, dw, du, ds0)`` as ``ref.wkv6_bwd_ref`` returns them,
    computed as the CUDA kernel computes them."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    nj = dv // COLS  # lanes a row
    rows_a_warp = 32 // nj
    rt, kt, wt, vt = (x.permute(0, 2, 1, 3).float() for x in (r, k, w, v))  # (b, h, s, d)
    dot = torch.zeros_like(vt) if do is None else do.permute(0, 2, 1, 3).float()
    uc = u.float()[None, :, :, None]  # (1, h, dk, 1)
    zero = torch.zeros((b, h, dk, dv))
    states, _ = _boundaries(kt, vt, wt, zero if s0 is None else s0.float(), False)
    cots, ds0 = _boundaries(rt, dot, wt, zero if dstate is None else dstate.float(), True)
    g_r, g_k, g_w = (torch.zeros((b, h, s, dk)) for _ in range(3))
    g_v = torch.zeros((b, h, s, dv))
    du_parts = []

    def groups(x):  # (b, h, dk, dv) -> (b, h, dk, nj, COLS)
        return x.reshape(b, h, dk, nj, COLS)

    def dv_sum(terms):  # (b, h, dk, dv): a warp's rows by the tree, then warps in order
        pad = -dk % rows_a_warp
        if pad:
            terms = torch.cat([terms, torch.zeros((b, h, pad, dv))], dim=2)
        warps = terms.reshape(b, h, -1, rows_a_warp, dv).transpose(-1, -2)  # (..., warp, dv, row)
        return _in_order(_tree(warps).movedim(2, -1))

    def step_dot(x):  # (b, h, live, dv): lane j takes j, j + 32, ..., then the lanes' tree
        pad = -dv % 32
        if pad:
            x = torch.cat([x, torch.zeros((*x.shape[:-1], pad))], dim=-1)
        return _tree(_in_order(x.reshape(*x.shape[:-1], -1, 32).transpose(-1, -2)))

    for n, t0 in enumerate(range(0, s, CHUNK)):
        t1 = min(s, t0 + CHUNK)
        dov = step_dot(dot[:, :, t0:t1] * vt[:, :, t0:t1])  # (b, h, live)
        du = torch.zeros((b, h, dk))  # the recompute's order: segments last to first
        st, g = states[n].clone(), cots[n].clone()
        ckpt = []
        for t in range(t0, t1):  # the checkpoint walk
            if (t - t0) % SEG == 0:
                ckpt.append(st)
            st = wt[:, :, t, :, None] * st + kt[:, :, t, :, None] * vt[:, :, t, None, :]
        for i in reversed(range(len(ckpt))):
            ta = t0 + i * SEG
            tb = min(t1, ta + SEG)
            st, hist = ckpt[i], []
            for t in range(ta, tb):  # S_{t-1} of the segment, and dr
                hist.append(st)
                part = _in_order(groups(dot[:, :, t, None, :] * st))  # (b, h, dk, nj)
                g_r[:, :, t] = _tree(part) + uc[..., 0] * kt[:, :, t] * dov[:, :, t - t0, None]
                du = du + rt[:, :, t] * kt[:, :, t] * dov[:, :, t - t0, None]
                st = wt[:, :, t, :, None] * st + kt[:, :, t, :, None] * vt[:, :, t, None, :]
            for t in reversed(range(ta, tb)):  # G walks back: dk, dw, dv
                dj, vj = dot[:, :, t, None, :], vt[:, :, t, None, :]
                x = g + (rt[:, :, t, :, None] * uc) * dj
                g_k[:, :, t] = _tree(_in_order(groups(x * vj)))
                g_w[:, :, t] = _tree(_in_order(groups(g * hist[t - ta])))
                g_v[:, :, t] = dv_sum(kt[:, :, t, :, None] * x)
                g = wt[:, :, t, :, None] * g + rt[:, :, t, :, None] * dj
        du_parts.append(du)
    g_u = torch.zeros((h, dk))
    for bi in range(b):
        for part in du_parts:
            g_u = g_u + part[bi]
    return (g_r.permute(0, 2, 1, 3), g_k.permute(0, 2, 1, 3), g_v.permute(0, 2, 1, 3),
            g_w.permute(0, 2, 1, 3), g_u, None if s0 is None else ds0)
