"""Error-feedback int8 gradient compression for the cross-pod DP reduction
(the JAX package's ``train/grad_compress.py``, whose arithmetic is plain
array code with no kernel: so is this).

Quantize the update to int8 with error feedback (EF-SGD / 1-bit Adam
lineage): the quantization residual is carried into the next step, so the
*accumulated* update is unbiased and convergence matches fp32 to first
order. ``compress -> decompress`` round-trips through (int8 values, fp32
per-block scales); block size 256 bounds the quantization range loss. The
payload and scales equal JAX's bit for bit, on the CPU and on the card:
fp32 division, round half to even (``torch.round``, as ``jnp.round``),
clip to ±127, scale floor 1e-12.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils import _pytree as pytree

Pytree = Any


def _quantize_block(x: torch.Tensor, block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.numel()) % block))
    blocks = flat.reshape(-1, block)
    # divided by a tensor: CUDA multiplies by the reciprocal of a number
    # divisor, which rounds apart from JAX's (and the CPU's) division
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.tensor(127.0, device=x.device)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def _dequantize_block(q: torch.Tensor, scale: torch.Tensor, shape, block: int) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


def compress(x: torch.Tensor, block: int = 256) -> Dict[str, torch.Tensor]:
    q, scale = _quantize_block(x.float(), block)
    return {"q": q, "scale": scale}


def decompress(payload: Dict[str, torch.Tensor], shape, block: int = 256) -> torch.Tensor:
    return _dequantize_block(payload["q"], payload["scale"], shape, block)


class ErrorFeedbackCompressor:
    """Stateful EF compressor over a grad tree.

    state = residual tree (fp32). apply(grads, state) ->
    (decompressed grads as seen post-reduction, new state).
    """

    def __init__(self, block: int = 256):
        self.block = block

    def init(self, grads: Pytree) -> Pytree:
        return pytree.tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads
        )

    def apply(self, grads: Pytree, residual: Pytree) -> Tuple[Pytree, Pytree]:
        def one(g, r):
            corrected = g.float() + r
            payload = compress(corrected, self.block)
            deq = decompress(payload, g.shape, self.block)
            new_r = corrected - deq
            return deq.to(g.dtype), new_r

        flat_g, spec = pytree.tree_flatten(grads)
        flat_r, r_spec = pytree.tree_flatten(residual)
        if r_spec != spec:
            raise ValueError("grads and residual must be trees of one structure")
        outs = [one(g, r) for g, r in zip(flat_g, flat_r)]
        deqs = pytree.tree_unflatten([o[0] for o in outs], spec)
        resids = pytree.tree_unflatten([o[1] for o in outs], spec)
        return deqs, resids


def wire_bytes(grads: Pytree, compressed: bool, block: int = 256) -> int:
    """Bytes crossing the slow link per reduction."""
    total = 0
    for g in pytree.tree_leaves(grads):
        n = g.numel()
        if compressed:
            n_blocks = -(-n // block)
            total += n + 4 * n_blocks  # int8 payload + fp32 scales
        else:
            total += 4 * n
    return total
