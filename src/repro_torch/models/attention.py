"""Attention: GQA/MQA, qk-norm, QKV bias, RoPE, and KV caches (linear
and ring, bf16/fp32 or int8) for decode.

Shapes follow (batch, seq, heads, head_dim) throughout, as in the JAX
package's ``models/attention.py``. Causal attention goes through the
flash-attention wrapper (the CUDA kernel for CUDA tensors, the plain
version on the CPU) under ``kernel_mode="kernel"``, and through the plain
version everywhere under ``"reference"``, where a prompt longer than
``q_chunk`` runs one query chunk at a time (memory only; the same result).

Decode (``attention_decode``) writes the new token's K/V into its slot of
the cache in place and attends one query to the cache. The valid keys
are a prefix of the cache (or all of it, once a ring has wrapped) shared
by the whole batch, so under ``"kernel"`` an unquantized cache needs no
mask: the flash-attention wrapper takes the view of the valid prefix,
non-causal, with a GQA group's query heads as query rows of its kv head
(``attend_prefix_folded``). An int8 cache takes the plain ``decode_attention_chunked``
on every device (the JAX package computes it in jnp, not in a kernel).
Under ``"reference"`` decode follows the JAX code: masked attention over
the whole cache, or the chunked scan at ``cap >= 8192``. Sliding-window
chunking is not ported yet. Positions are (b, s) ids under RoPE and (b,
3, s) (temporal, height, width) ids under M-RoPE.

On a model axis (``dist.api``), JAX's sites split the q heads
(``("data", None, "model", None)``) and the projections' columns
(``wq``/``wk``/``wv`` column-parallel, ``wo`` row-parallel) where the guard
lets them (``_heads``): a rank runs K3 on its local q heads, and reads
its local kv heads where the guard splits them too, or else the whole
``k``/``v`` (all-gathered from its column pieces, as JAX's whole ``k``/
``v`` constraint does) cut to its q heads' groups. q heads the guard
does not split (hymba's 25) are gathered whole, attention runs whole on
every rank, and ``wo`` takes the rank's rows of it. The caches hold the
layer's ``k``/``v`` as the rank computes them: its local kv heads, or all.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import ModelAxis, model_axis, split_at
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref
from repro_torch.models.layers import (
    Params,
    apply_mrope,
    apply_rope,
    dense_init,
    rmsnorm_head,
)


def attention_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, lead: Tuple[int, ...] = ()
) -> Params:
    dev = gen.device
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dtype, lead),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, lead),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dtype, lead),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dtype, lead),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(*lead, cfg.q_dim, dtype=dtype, device=dev)
        p["bk"] = torch.zeros(*lead, cfg.kv_dim, dtype=dtype, device=dev)
        p["bv"] = torch.zeros(*lead, cfg.kv_dim, dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(*lead, cfg.head_dim, dtype=dtype, device=dev)
    return p


def full_attention(
    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, sk, hkv, d)
    v: torch.Tensor,  # (b, sk, hkv, d)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    kernel_mode: str = "kernel",
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Exact softmax attention with grouped KV heads, fp32 softmax.
    ``q_chunk`` bounds the plain path's score memory to one chunk of
    queries (the JAX package's ``causal_chunked_attention``): applied when
    the queries are more than it and a multiple of it; the kernel tiles by
    itself."""
    if kernel_mode == "reference":
        sq = q.shape[1]
        if q_chunk is None or sq <= q_chunk or sq % q_chunk:
            return attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
        return torch.cat([
            attention_ref(q[:, i : i + q_chunk], k, v, causal=causal, window=window,
                          q_offset=q_offset + i)
            for i in range(0, sq, q_chunk)
        ], dim=1)
    # the kernel tiles internally: blocks as large as the sequences keep the
    # wrapper's divisibility contract trivially satisfied
    return fa_ops.flash_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        block_q=q.shape[1], block_k=k.shape[1],
    )


class _Heads(NamedTuple):
    """One attention layer on the model axis ``ax`` (module docstring):
    which params are the rank's column (``wo``: row) pieces, whether it
    computes its local q heads and local kv heads, and the kv heads its q
    heads read when ``k``/``v`` are whole; ``n_q`` and ``n_kv`` count the
    heads it computes."""

    ax: ModelAxis
    q_cols: bool  # wq / bq columns, wo rows
    kv_cols: bool  # wk / wv / bk / bv columns
    q: bool
    kv: bool
    kv_groups: slice
    n_q: int
    n_kv: int


def _heads(cfg: ArchConfig, x: torch.Tensor) -> _Heads:
    ax = model_axis()
    if ax.size == 1:
        return _Heads(ax, False, False, False, False, slice(None), cfg.n_heads, cfg.n_kv_heads)
    b, s, hd = x.shape[0], x.shape[1], cfg.head_dim
    cols = lambda n: split_at((None, "model"), (cfg.d_model, n)).size > 1  # noqa: E731
    heads = lambda n: split_at(("data", None, "model", None), (b, s, n, hd)).size > 1  # noqa: E731
    n_rep, hq = cfg.n_heads // cfg.n_kv_heads, cfg.n_heads // ax.size
    # GQA groups whole within a rank's q heads, or a rank's q heads within one group
    q = heads(cfg.n_heads) and (hq % n_rep == 0 or n_rep % hq == 0)
    kv, lo = q and heads(cfg.n_kv_heads), ax.rank * hq // n_rep
    return _Heads(ax, cols(cfg.q_dim), cols(cfg.kv_dim), q, kv, slice(lo, lo + max(1, hq // n_rep)),
                  hq if q else cfg.n_heads, cfg.n_kv_heads // ax.size if kv else cfg.n_kv_heads)


def _project_qkv(p: Params, cfg: ArchConfig, x: torch.Tensor, lay: _Heads, kernel_mode: str):
    b, s = x.shape[0], x.shape[1]
    xs = lay.ax.copy(x) if lay.q_cols or lay.kv_cols else x

    def project(name: str, cols: bool, local_heads: bool, n: int) -> torch.Tensor:
        t = (xs if cols else x) @ p["w" + name]
        if cfg.qkv_bias:
            t = t + p["b" + name]
        if cols and not local_heads:  # the whole heads from the ranks' columns
            t = lay.ax.gather(t)
        return t.reshape(b, s, n, cfg.head_dim)

    q = project("q", lay.q_cols, lay.q, lay.n_q)
    k = project("k", lay.kv_cols, lay.kv, lay.n_kv)
    v = project("v", lay.kv_cols, lay.kv, lay.n_kv)
    if cfg.qk_norm:  # a scale shared by local heads: its gradient summed over the ranks
        qs, ks = p["q_norm"], p["k_norm"]
        q = rmsnorm_head(lay.ax.copy(qs) if lay.q else qs, q, cfg.norm_eps, kernel_mode=kernel_mode)
        k = rmsnorm_head(lay.ax.copy(ks) if lay.kv else ks, k, cfg.norm_eps, kernel_mode=kernel_mode)
    return q, k, v


def _group_kv(lay: _Heads, t: torch.Tensor) -> torch.Tensor:
    """Whole ``k``/``v`` (or a cache's, or its scales), dim 2 the kv heads,
    cut to the groups of the rank's local q heads."""
    if lay.q and not lay.kv:
        return lay.ax.copy(t)[:, :, lay.kv_groups]
    return t


def _out_proj(p: Params, lay: _Heads, out: torch.Tensor) -> torch.Tensor:
    """``wo`` on the heads' output (b, s, heads · head_dim), row-parallel
    where the rank holds its rows."""
    if lay.q_cols and not lay.q:
        out = lay.ax.split(out)
    y = out @ p["wo"]
    return lay.ax.reduce(y) if lay.q_cols else y


def _apply_positions(cfg: ArchConfig, q, k, positions):
    """RoPE on (b, s) positions, M-RoPE on (b, 3, s) ones, or nothing."""
    if cfg.rope_variant == "none":
        return q, k
    rope = apply_mrope if cfg.rope_variant == "mrope" else apply_rope
    return rope(q, positions, cfg.rope_theta), rope(k, positions, cfg.rope_theta)


def attend(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
    kernel_mode: str = "kernel", q_chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Causal self-attention over the full sequence; returns the output
    projection and the layer's (rotated) keys and values, which prefill
    keeps as its KV cache."""
    lay = _heads(cfg, x)
    q, k, v = _project_qkv(p, cfg, x, lay, kernel_mode)
    q, k = _apply_positions(cfg, q, k, positions)
    out = full_attention(
        q, _group_kv(lay, k), _group_kv(lay, v), causal=True,
        window=cfg.sliding_window or None, kernel_mode=kernel_mode, q_chunk=q_chunk,
    )
    b, s = x.shape[0], x.shape[1]
    return _out_proj(p, lay, out.reshape(b, s, lay.n_q * cfg.head_dim)), k, v


def attention_apply(
    p: Params, cfg: ArchConfig, x: torch.Tensor, positions: torch.Tensor, *,
    kernel_mode: str = "kernel", q_chunk: int = 4096,
) -> torch.Tensor:
    """Training / prefill path over the full sequence (causal)."""
    return attend(p, cfg, x, positions, kernel_mode=kernel_mode, q_chunk=q_chunk)[0]


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_kv_cache(
    cfg: ArchConfig, batch: int, capacity: int, dtype: torch.dtype, quantized: bool = False,
    *, device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Per-layer stacked cache ``(n_layers, batch, capacity, hkv, head_dim)``.
    For sliding-window archs the capacity should be the window (a ring);
    otherwise the longest context. ``quantized``: int8 ``k``/``v`` and one
    fp16 scale a (token, head), ``k_scale``/``v_scale`` ``(n_layers,
    batch, capacity, hkv)``."""
    shape = (cfg.n_layers, batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    if not quantized:
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "k_scale": torch.zeros(shape[:-1], dtype=torch.float16, device=device),
        "v_scale": torch.zeros(shape[:-1], dtype=torch.float16, device=device),
    }


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., head_dim) -> int8 values and an fp16 scale a vector: the
    scale is ``max|x| / 127`` floored at 1e-8 (fp32 while the values are
    divided by it), values rounded half to even and clipped to ±127."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale.float()[..., None]).to(dtype)


def cache_capacity(cfg: ArchConfig, seq_len: int) -> int:
    if cfg.sliding_window > 0:
        return min(cfg.sliding_window, seq_len)
    return seq_len


def masked_attention(
    q: torch.Tensor,  # (b, sq, hq, d)
    k: torch.Tensor,  # (b, sk, hkv, d)
    v: torch.Tensor,  # (b, sk, hkv, d)
    kv_mask: torch.Tensor,  # (b, sk) valid keys
) -> torch.Tensor:
    """Non-causal attention over the keys ``kv_mask`` marks, fp32 softmax:
    the JAX package's ``full_attention(causal=False, kv_mask=...)``."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * (d ** -0.5)
    logits = logits.masked_fill(~kv_mask[:, None, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def decode_attention_chunked(
    q: torch.Tensor,  # (b, 1, hq, d)
    k: torch.Tensor,  # (b, cap, hkv, d): the compute dtype or int8
    v: torch.Tensor,  # (b, cap, hkv, d)
    kv_mask: torch.Tensor,  # (b, cap)
    chunk: int = 2048,
    scales: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # (b, cap, hkv) fp16 each
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Flash-decoding in plain torch: an online-softmax loop over cache
    chunks, so the fp32 working set is one chunk's; an int8 cache is
    dequantized a chunk at a time. A capacity that ``chunk`` does not
    divide dequantizes the whole cache and takes ``masked_attention``."""
    b, cap, hkv, d = k.shape
    hq = q.shape[2]
    n_rep = hq // hkv
    out_dtype = out_dtype or (v.dtype if scales is None else torch.bfloat16)
    if cap % chunk:
        if scales is not None:
            k = dequantize_kv(k, scales[0], out_dtype)
            v = dequantize_kv(v, scales[1], out_dtype)
        return masked_attention(q, k, v, kv_mask)
    qg = q.reshape(b, 1, hkv, n_rep, d).float()
    m = torch.full((b, hkv, n_rep, 1, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, n_rep, 1, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, n_rep, d), dtype=torch.float32, device=q.device)
    for i in range(0, cap, chunk):
        k_c, v_c = k[:, i : i + chunk], v[:, i : i + chunk]
        if scales is not None:
            k_c = dequantize_kv(k_c, scales[0][:, i : i + chunk], out_dtype)
            v_c = dequantize_kv(v_c, scales[1][:, i : i + chunk], out_dtype)
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k_c.float()) * (d ** -0.5)
        logits = logits.masked_fill(~kv_mask[:, None, None, None, i : i + chunk], NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        p = torch.exp(logits - m_new)
        corr = torch.exp(m - m_new)
        l = corr * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bhrqk,bkhd->bhrqd", p.to(v_c.dtype).float(), v_c.float())
        acc = corr[..., 0] * acc + pv[..., 0, :]
        m = m_new
    out = acc / torch.clamp(l[..., 0], min=1e-30)
    return out.reshape(b, 1, hq, d).to(out_dtype)


def attend_prefix_folded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """One query a sequence ``q`` (b, 1, hq, d) against every key of ``k``
    / ``v`` (b, sk, hkv, d), non-causal, through the flash-attention
    wrapper with GQA folded into query rows: the ``hq / hkv`` query heads
    of kv head ``g`` go in as that many query rows of head ``g`` (a view;
    legal because every row sees the same keys). A kernel block then
    holds a kv head's whole group and reads its K/V once, where one query
    row a head reads them once a query head (on an H100 up to 3.9x faster
    at decode's shapes, ``PERF.md``)."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    rows = q.reshape(b, hkv, hq // hkv, d).transpose(1, 2)  # (b, n_rep, hkv, d)
    out = full_attention(rows, k, v, causal=False)
    return out.transpose(1, 2).reshape(b, 1, hq, d)


def decode_slot(cfg: ArchConfig, cap: int, pos: int) -> Tuple[int, int]:
    """The slot the token at ``pos`` is written to, and how many slots
    from the first are then valid. A ring (``sliding_window == cap``)
    writes ``pos % cap`` and is all valid once it has wrapped; a linear
    cache writes ``min(pos, cap - 1)``, so past its capacity it
    overwrites its last slot, as the JAX package does."""
    if cfg.sliding_window > 0 and cap == cfg.sliding_window:
        slot = pos % cap
        return slot, (cap if pos >= cap else slot + 1)
    slot = min(pos, cap - 1)
    return slot, slot + 1


def attention_decode(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (b, 1, d_model)
    positions: torch.Tensor,  # (b, 1); M-RoPE: (b, 3, 1)
    layer_cache: Dict[str, torch.Tensor],  # "k", "v": (b, cap, hkv, d) (+ int8 scales)
    pos: int,  # tokens cached so far
    *,
    kernel_mode: str = "kernel",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against a (ring or linear, int8 or not) KV cache.
    Writes the new token's K/V into ``layer_cache``'s tensors in place and
    returns ``(output projection, layer_cache)``."""
    lay = _heads(cfg, x)
    q, k_new, v_new = _project_qkv(p, cfg, x, lay, kernel_mode)
    q, k_new = _apply_positions(cfg, q, k_new, positions)
    quantized = "k_scale" in layer_cache
    cache_k, cache_v = layer_cache["k"], layer_cache["v"]
    cap = cache_k.shape[1]
    slot, n_valid = decode_slot(cfg, cap, pos)
    if quantized:
        kq, ks = quantize_kv(k_new)
        vq, vs = quantize_kv(v_new)
        cache_k[:, slot : slot + 1] = kq
        cache_v[:, slot : slot + 1] = vq
        layer_cache["k_scale"][:, slot : slot + 1] = ks
        layer_cache["v_scale"][:, slot : slot + 1] = vs
    else:
        cache_k[:, slot : slot + 1] = k_new
        cache_v[:, slot : slot + 1] = v_new
    b = x.shape[0]
    keys, values = _group_kv(lay, cache_k), _group_kv(lay, cache_v)
    if kernel_mode == "kernel" and not quantized:
        # the valid keys are the prefix [0, n_valid) for every sequence
        out = attend_prefix_folded(q, keys[:, :n_valid], values[:, :n_valid])
    else:
        valid = torch.arange(cap, device=x.device) < n_valid
        kv_mask = valid[None, :].expand(b, cap)
        if cap >= 8192 or quantized:
            scales = tuple(_group_kv(lay, layer_cache[n]) for n in ("k_scale", "v_scale")) \
                if quantized else None
            out = decode_attention_chunked(
                q, keys, values, kv_mask, chunk=min(2048, cap), scales=scales,
                out_dtype=x.dtype,
            )
        else:
            out = masked_attention(q, keys, values, kv_mask)
    return _out_proj(p, lay, out.reshape(b, 1, lay.n_q * cfg.head_dim)), layer_cache
