"""The WKV6 CUDA kernel's arithmetic (``src/repro_torch/csrc/wkv6.cu``)
rehearsed in plain torch on the CPU, for ``tests/test_torch_kernels_rwkv.py``:
``wkv6_subchunk_ref`` (sub-chunks, reference points, 3xTF32) and the TF32
rounding and 3xTF32 product it is built from."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


# the CUDA kernel's floor on log w (-60), in log2 units, and on w
LOG2_FLOOR = -60.0 * math.log2(math.e)
W_FLOOR = math.exp(-60.0)
SUB = 16  # rows a sub-chunk


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32's 10-bit mantissa, to nearest with ties away
    from zero, on the int32 view (what ``cvt.rna.tf32.f32`` does)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` as the kernel's 3xTF32 split: with x = big + small, both
    TF32, small*big + big*small + big*big."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _decay2(x: torch.Tensor) -> torch.Tensor:
    """2^x for an exponent that is <= 0 in exact arithmetic (clamped at 0)."""
    return torch.exp2(torch.clamp(x, max=0.0))


def _diagonal_block(r, k, w, cum, u):
    """Scores of one diagonal block (rows = columns = the sub-chunk's m <= 16
    rows) as the kernel forms them: 8 x 8 quarters, each column carrying
    k[s] times the product of the decays between s and the row, reset to
    k[s] on row s; the lower left quarter starts from one exp2 a channel.
    Inputs (b, h, m, dk); returns (b, h, m, m)."""
    b, h, m, _ = r.shape
    scores = torch.zeros((b, h, m, m), dtype=torch.float32)
    bonus = (r * u[None, :, None, :] * k).sum(-1)  # (b, h, m): s = t
    for s0 in range(0, m, 8):
        cols = torch.arange(s0, min(s0 + 8, m))
        kk = k[:, :, cols]
        for r0 in range(s0, m, 8):
            if r0 == s0:
                kf = kk.clone()
            else:
                kf = kk * _decay2(cum[:, :, r0 - 1:r0] - cum[:, :, cols])
            for t in range(r0, min(r0 + 8, m)):
                acc = (r[:, :, t:t + 1] * kf).sum(-1)  # (b, h, columns)
                if r0 == s0:
                    at = torch.where(cols < t, acc, torch.where(cols == t, bonus[:, :, cols],
                                                                torch.zeros_like(acc)))
                    kf = torch.where((cols == t)[:, None], kk, kf * w[:, :, t:t + 1])
                else:
                    at = acc
                    kf = kf * w[:, :, t:t + 1]
                scores[:, :, t, cols] = at
    return scores


def wkv6_subchunk_ref(
    r: torch.Tensor,  # (b, s, h, dk) fp32
    k: torch.Tensor,
    v: torch.Tensor,  # (b, s, h, dv)
    w: torch.Tensor,  # (b, s, h, dk), decay in (0, 1)
    u: torch.Tensor,  # (h, dk)
    *,
    chunk: int = 64,
    s0: Optional[torch.Tensor] = None,  # (b, h, dk, dv)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel's arithmetic (``csrc/wkv6.cu``) in plain torch, for
    the tests: chunks of ``chunk`` rounded up to 16 steps (the last takes
    what is left); logs and sums in log2 units with log w floored at -60
    (w at e^-60), ``cum_prev`` the previous row's ``cum``; sub-chunks of 16
    rows whose scores against every earlier row are one product through the
    reference point ``ref_i = cum[start_i - 1]``, the diagonal blocks pair
    by pair with the decays carried down the rows as products; every product
    in 3xTF32. Returns ``(o, final state)`` as ``wkv6_ref``."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    chunk = -(-chunk // SUB) * SUB
    rt, kt, vt, wt = (x.permute(0, 2, 1, 3).float() for x in (r, k, v, w))  # (b, h, s, d)
    state = (torch.zeros((b, h, dk, dv), dtype=torch.float32) if s0 is None
             else s0.float().clone())
    outs = []
    for t0 in range(0, s, chunk):
        rc, kc, vc, wc = (x[:, :, t0:t0 + chunk] for x in (rt, kt, vt, wt))
        n = rc.shape[2]
        wc = torch.clamp(wc, min=W_FLOOR)
        cum = torch.cumsum(torch.clamp(torch.log2(wc), min=LOG2_FLOOR), dim=2)
        prev = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]], dim=2)
        scores = torch.zeros((b, h, n, n), dtype=torch.float32)
        for start in range(0, n, SUB):
            stop = min(start + SUB, n)
            if start:  # every earlier row: one product through ref_i
                ref = cum[:, :, start - 1:start]
                r_ref = rc[:, :, start:stop] * _decay2(prev[:, :, start:stop] - ref)
                k_ref = kc[:, :, :start] * _decay2(ref - cum[:, :, :start])
                scores[:, :, start:stop, :start] = _mm3(r_ref, k_ref.transpose(-1, -2))
            block = slice(start, stop)
            scores[:, :, block, block] = _diagonal_block(
                rc[:, :, block], kc[:, :, block], wc[:, :, block], cum[:, :, block], u)
        last = cum[:, :, -1:]
        o = _mm3(rc * _decay2(prev), state) + _mm3(scores, vc)
        k_dec = kc * _decay2(last - cum)
        state = _decay2(last).transpose(-1, -2) * state + _mm3(k_dec.transpose(-1, -2), vc)
        outs.append(o)
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3), state
