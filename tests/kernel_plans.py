"""The kernels' launch plans as the tests walk them: the tensor-map
geometry the flash-attention wrapper encodes, the query steps and dK/dV
blocks of the fp32 flash backward, and the rows each RMSNorm backward
block sums. Pure functions of the shapes, each mirroring what a CUDA
kernel computes for itself; test code, kept out of ``src/`` (which the
lint budget covers), for ``tests/test_torch_kernels_flash.py`` and
``tests/test_torch_kernels_rmsnorm.py``."""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.kernels.flash_attention import ops as fa
from repro_torch.kernels.fused_rmsnorm import ops as rms


def tma_geometry(
    shape: Sequence[int], strides: Sequence[int], data_ptr: int, element_size: int
) -> fa.TmaGeometry:
    """The rank-4 tensor map of a ``(b, s, h, d)`` view with a contiguous
    last dimension (element strides ``strides``): dims innermost first,
    byte strides of the head, sequence and batch dimensions, and the box.
    A dimension of size 1 is never stepped over, so its stride is taken as
    the extent of the dimensions inside it. Raises ``ValueError`` where TMA
    cannot read the view (the wrapper's own checks)."""
    fa._check_base(data_ptr)
    return fa._geometry(tuple(shape), tuple(strides), element_size)


def tf32_stream_rows(d: int) -> int:
    """Rows of a streamed tile on the fp32 tensor-core route (queries in
    the dK/dV pass, keys in the dQ pass; ``kTcStream`` in the source): 64
    at d 64, 32 at d 128, 16 at d 256."""
    return {64: 64, 128: 32, 256: 16}[d]


def bwd_query_steps(k0: int, rows: int, sq: int, sk: int, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0) -> range:
    """The first query row of each step a dK/dV block walks for the key
    tile at ``k0``, ``rows`` queries a step: the steps cover every query
    that sees a key of the tile, from ``max(0, k0 - q_offset)`` under the
    causal mask to the window's last, as the kernels compute the band."""
    k_last = min(k0 + fa.BWD_TILE, sk) - 1
    q_lo = max(0, k0 - q_offset) if causal else 0
    q_hi = min(sq, k_last + window - q_offset) if window else sq
    if q_hi <= q_lo:
        return range(0)
    return range(q_lo // rows * rows, q_hi, rows)


def flash_bwd_blocks(plan: fa.BwdPlan, b: int, hq: int, hkv: int):
    """The dK/dV blocks in the kernel's grid order (x: key-tile pair, y:
    split, z: batch and kv head), each as ``(batch, kv head, split, key
    tiles, query heads)``: the tiles in the order the block walks them,
    the heads in the order it sums them."""
    n_kt, n_rep = plan.key_tiles, hq // hkv
    heads = n_rep // plan.splits
    n_x = -(-n_kt // 2) if plan.paired else n_kt
    for z in range(b * hkv):
        bi, hk = divmod(z, hkv)
        for g in range(plan.splits):
            for p in range(n_x):
                tiles = (p, n_kt - 1 - p) if plan.paired and n_kt - 1 - p != p else (p,)
                h0 = hk * n_rep + g * heads
                yield bi, hk, g, tiles, tuple(range(h0, h0 + heads))


def rmsnorm_bwd_rows(rows: int, shape: rms.BwdShape, blocks: int):
    """The rows each (block, slot) of the RMSNorm backward reduces, in the
    order it sums them into its dscale partial: block i takes row groups i,
    i + blocks, ...; slot j of a group is its row j. The block's partial
    row sums its slots' sums in slot order; the second kernel sums the
    blocks' rows in block order."""
    slots = shape.rows_per_block
    groups = -(-rows // slots)
    return [[[grp * slots + j for grp in range(i, groups, blocks) if grp * slots + j < rows]
             for j in range(slots)] for i in range(blocks)]
