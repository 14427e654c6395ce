"""The WKV6 backward kernel's arithmetic (``src/repro_torch/csrc/wkv6_bwd.cu``)
rehearsed in plain torch on the CPU, for ``tests/test_torch_kernels_rwkv.py``:
``wkv6_bwd_segmented`` walks the kernel's blocks (one a column tile of 16
state columns, batch and head, vectorised here over batch, head and row),
its forward sweep writing a checkpoint of the state at the start of each
16-step segment, its reverse sweep recomputing a segment's states from the
checkpoint, ``dw`` as the product of the state and its cotangent (no
division, no logarithm), and its sums in the kernel's orders: the tiles'
partial rows of ``dr``, ``dk``, ``dw`` in tile order, ``du``'s partials in
(batch, tile) order, ``dv`` over the rows in row order."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

SEG = 16  # steps a segment (kSeg)
TILE = 16  # state columns a block (kTile; dv if smaller)


def wkv6_bwd_segmented(
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
    tj = min(TILE, dv)
    tiles = dv // tj
    rt, kt, wt, vt = (x.permute(0, 2, 1, 3).float() for x in (r, k, w, v))  # (b, h, s, d)
    dot = (torch.zeros_like(vt) if do is None else do.permute(0, 2, 1, 3).float())
    uc = u.float()[None, :, :]  # (1, h, dk)
    parts = torch.zeros((3, tiles, b, h, s, dk))  # dr, dk, dw
    g_v = torch.zeros((b, h, s, dv))
    du_part = torch.zeros((b, tiles, h, dk))
    ds0 = None if s0 is None else torch.zeros((b, h, dk, dv))
    segments = [(t0, min(s, t0 + SEG)) for t0 in range(0, s, SEG)]
    for tile in range(tiles):
        cols = slice(tile * tj, (tile + 1) * tj)
        st = (torch.zeros((b, h, dk, tj)) if s0 is None else s0[..., cols].float().clone())
        ckpt = []
        du = torch.zeros((b, h, dk))
        for t0, t1 in segments:  # forward sweep: checkpoints, dr, du
            ckpt.append(st.clone())
            for t in range(t0, t1):
                vj, dj = vt[:, :, t, None, cols], dot[:, :, t, None, cols]  # (b, h, 1, tj)
                dov = (dj * vj).sum(-1)  # (b, h, 1)
                parts[0, tile, :, :, t] = (dj * st).sum(-1) + uc * kt[:, :, t] * dov
                du = du + rt[:, :, t] * kt[:, :, t] * dov
                st = wt[:, :, t, :, None] * st + kt[:, :, t, :, None] * vj
        g = (torch.zeros((b, h, dk, tj)) if dstate is None else dstate[..., cols].float().clone())
        for i in reversed(range(len(segments))):  # reverse sweep, a segment at a time
            t0, t1 = segments[i]
            st, hist = ckpt[i], []
            for t in range(t0, t1):  # the segment's states from its checkpoint
                hist.append(st)
                st = wt[:, :, t, :, None] * st + kt[:, :, t, :, None] * vt[:, :, t, None, cols]
            for t in reversed(range(t0, t1)):
                vj, dj = vt[:, :, t, None, cols], dot[:, :, t, None, cols]
                x = g + (rt[:, :, t] * uc)[..., None] * dj
                parts[1, tile, :, :, t] = (x * vj).sum(-1)
                parts[2, tile, :, :, t] = (g * hist[t - t0]).sum(-1)
                terms = kt[:, :, t, :, None] * x  # (b, h, dk, tj): dv's, summed in row order
                acc = terms[:, :, 0]
                for c in range(1, dk):
                    acc = acc + terms[:, :, c]
                g_v[:, :, t, cols] = acc
                g = wt[:, :, t, :, None] * g + rt[:, :, t, :, None] * dj
        if ds0 is not None:
            ds0[..., cols] = g
        du_part[:, tile] = du
    summed = parts[:, 0].clone()
    for tile in range(1, tiles):
        summed = summed + parts[:, tile]
    g_r, g_k, g_w = (x.permute(0, 2, 1, 3) for x in summed)
    g_u = torch.zeros((h, dk))
    for bi in range(b):
        for tile in range(tiles):
            g_u = g_u + du_part[bi, tile]
    return g_r, g_k, g_v.permute(0, 2, 1, 3), g_w, g_u, ds0
