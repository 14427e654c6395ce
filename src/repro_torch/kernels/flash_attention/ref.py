"""Plain PyTorch attention: the CPU path of ``ops.flash_attention`` and the
yardstick its CUDA kernel is held against on the card. Exact softmax
attention with GQA head grouping, causal and sliding-window masks with a
query offset, fp32 logits and softmax — the JAX package's jnp oracle
(``ref.attention_ref``), with one difference it never exercises: a query
row with no valid key gives 0, as the flash kernels (Pallas and CUDA) do,
where the oracle's softmax over an all-masked row averages the values.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0e38


def attention_ref(
    q: torch.Tensor,  # (b, s_q, hq, d)
    k: torch.Tensor,  # (b, s_k, hkv, d)
    v: torch.Tensor,  # (b, s_k, hkv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> torch.Tensor:
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    qg = q.reshape(b, sq, hkv, n_rep, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * (d ** -0.5)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None and window > 0:
        mask = mask & (kpos > qpos - window)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * mask.any(dim=-1, keepdim=True)  # no valid key -> 0
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)
