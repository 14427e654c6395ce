"""Plain PyTorch attention: the CPU path of ``ops.flash_attention`` and the
yardstick its CUDA kernel is held against on the card. Exact softmax
attention with GQA head grouping, causal and sliding-window masks with a
query offset, fp32 logits and softmax — the JAX package's jnp oracle
(``ref.attention_ref``), with one difference it never exercises: a query
row with no valid key gives 0, as the flash kernels (Pallas and CUDA) do,
where the oracle's softmax over an all-masked row averages the values.

Also the plain versions of the backward: ``attention_lse_ref`` (the
output and each row's log-sum-exp, which the forward kernel saves) and
``attention_bwd_ref`` (dq, dk, dv by the explicit formulas the backward
kernel evaluates).
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    logits = logits.masked_fill(~mask, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    probs = probs * mask.any(dim=-1, keepdim=True)  # no valid key -> 0
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def _mask(sq, sk, causal, window, q_offset, device) -> torch.Tensor:
    """(sq, sk) bool: which keys each query sees."""
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None and window > 0:
        mask = mask & (kpos > qpos - window)
    return mask


def _scores(q, k, causal, window, q_offset):
    """Scaled fp32 scores ``(b, hkv, n_rep, sq, sk)``, -inf where masked,
    and the mask."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * (d ** -0.5)
    mask = _mask(sq, sk, causal, window, q_offset, q.device)
    return s.masked_fill(~mask, float("-inf")), mask


def attention_lse_ref(
    q: torch.Tensor,  # (b, s_q, hq, d)
    k: torch.Tensor,  # (b, s_k, hkv, d)
    v: torch.Tensor,  # (b, s_k, hkv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``attention_ref``'s output and each query row's log-sum-exp of the
    scaled scores, fp32 ``(b, hq, s_q)`` in natural units, ``-inf`` for a
    row with no valid key: what the forward kernel writes for the
    backward."""
    b, sq, hq, d = q.shape
    s, _ = _scores(q, k, causal, window, q_offset)
    lse = torch.logsumexp(s, dim=-1)  # -inf where every key is masked
    out = attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    return out, lse.reshape(b, hq, sq)


def attention_bwd_ref(
    dout: torch.Tensor,  # (b, s_q, hq, d)
    q: torch.Tensor,
    k: torch.Tensor,  # (b, s_k, hkv, d)
    v: torch.Tensor,
    out: torch.Tensor,  # the forward's output
    lse: torch.Tensor,  # (b, hq, s_q) fp32
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv of attention by the formulas the backward kernel
    evaluates, fp32 inside, each in its input's dtype: ``P = exp(S - lse)``
    (0 where masked or ``lse = -inf``), ``dV = Pᵀ dO``, ``dP = dO Vᵀ``,
    ``dS = P (dP - D)`` with ``D = rowsum(dO O)``, ``dQ = scale dS K``,
    ``dK = scale dSᵀ Q``; the GQA group's query heads sum into their kv
    head."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    n_rep = hq // hkv
    scale = d ** -0.5
    s, mask = _scores(q, k, causal, window, q_offset)
    lse_g = lse.float().reshape(b, hkv, n_rep, sq, 1)
    live = mask & torch.isfinite(lse_g)
    p = torch.where(live, torch.exp(s - lse_g.nan_to_num(neginf=0.0)), 0.0)
    go = dout.float().reshape(b, sq, hkv, n_rep, d)
    dvec = (dout.float() * out.float()).sum(-1)  # (b, sq, hq)
    dvec = dvec.reshape(b, sq, hkv, n_rep).permute(0, 2, 3, 1)[..., None]
    dp = torch.einsum("bqhrd,bkhd->bhrqk", go, v.float())
    ds = p * (dp - dvec)
    dv = torch.einsum("bhrqk,bqhrd->bkhd", p, go)
    dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, q.float().reshape(b, sq, hkv, n_rep, d)) * scale
    dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, k.float()).reshape(b, sq, hq, d) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
