"""RWKV-6 (Finch): token-shift time-mix with data-dependent decay +
channel-mix, forward only (the JAX package's ``models/rwkv.py``).

WKV recurrence per head (state S: (dk, dv)):
    o_t = r_t @ (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
with a per-token, per-channel decay w_t in (0, 1) made by a LoRA on the
shifted input.

Paths:
  * ``wkv_ref``     — step-by-step oracle (+ the single decode step with s0),
  * ``wkv_chunked`` — chunk-sequential, intra-chunk parallel (plain torch),
  * the CUDA kernel — ``repro_torch.kernels.rwkv_scan.ops.wkv6``.

``tmix_apply`` takes the kernel under ``kernel_mode="kernel"`` (its
plain version on a CPU tensor), at any length and with ``s0``. Under
``"reference"`` it takes ``wkv_chunked``, and ``wkv_ref`` with ``s0`` for
``s == 1``, as the JAX package does.

Where JAX promotes an fp32 × bf16 ``einsum`` to fp32, the bf16 leaf is
upcast explicitly here (torch's matmul takes one dtype), so both compute
the same thing.

On a model axis (``dist.api``; JAX's ``("data", None, "model", None)`` on
``r``) the params are the rank's pieces: time-mix ``wr``/``wk``/``wv``/``wg``
are column-parallel on the rank's heads, where K4, the decay, the bonus
and the per-head norm run, and ``wo`` is row-parallel and all-reduced;
heads the guard does not split are gathered and run whole. The columns
the rules split elsewhere are joined as the guard says: the mixing
LoRA's (``mix_w1``) and channel-mix ``wr``'s are all-gathered, channel-mix
``wk``/``wv`` are column/row-parallel and all-reduced.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import split_at
from repro_torch.kernels.rwkv_scan import ops as wkv_ops
from repro_torch.kernels.rwkv_scan.ref import wkv6_ref
from repro_torch.models.layers import Params, dense_init

LORA_DIM_DECAY = 64
LORA_DIM_MIX = 32
N_MIX = 5  # r, k, v, w, g


def rwkv_dims(cfg: ArchConfig) -> Tuple[int, int]:
    hd = cfg.rwkv_head_dim
    return cfg.d_model // hd, hd  # (heads, head_dim)


# ---------------------------------------------------------------------------
# Init (``lead`` prepends stacking axes, e.g. (n_layers,))
# ---------------------------------------------------------------------------


def tmix_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, lead: Tuple[int, ...] = ()
) -> Params:
    d = cfg.d_model
    h, hd = rwkv_dims(cfg)
    f32, dev = torch.float32, gen.device
    return {
        "mu_x": torch.full((*lead, d), 0.5, dtype=f32, device=dev),
        "mu": torch.full((*lead, N_MIX, d), 0.5, dtype=f32, device=dev),  # r,k,v,w,g bases
        "mix_w1": dense_init(gen, d, N_MIX * LORA_DIM_MIX, f32, lead),
        "mix_w2": torch.randn(*lead, N_MIX, LORA_DIM_MIX, d, generator=gen, device=dev).mul_(0.02),
        "decay_base": torch.full((*lead, d), -6.0, dtype=f32, device=dev),
        "decay_w1": dense_init(gen, d, LORA_DIM_DECAY, f32, lead),
        "decay_w2": dense_init(gen, LORA_DIM_DECAY, d, f32, lead),
        "bonus": torch.randn(*lead, h, hd, generator=gen, device=dev).mul_(0.02),
        "wr": dense_init(gen, d, d, dtype, lead),
        "wk": dense_init(gen, d, d, dtype, lead),
        "wv": dense_init(gen, d, d, dtype, lead),
        "wg": dense_init(gen, d, d, dtype, lead),
        "wo": dense_init(gen, d, d, dtype, lead),
        "ln_x": torch.ones((*lead, d), dtype=f32, device=dev),
    }


def cmix_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, lead: Tuple[int, ...] = ()
) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": torch.full((*lead, d), 0.5, dtype=torch.float32, device=gen.device),
        "mu_r": torch.full((*lead, d), 0.5, dtype=torch.float32, device=gen.device),
        "wk": dense_init(gen, d, f, dtype, lead),
        "wv": dense_init(gen, f, d, dtype, lead),
        "wr": dense_init(gen, d, d, dtype, lead),
    }


# ---------------------------------------------------------------------------
# WKV core
# ---------------------------------------------------------------------------


# The step-by-step oracle (+ the single decode step with s0) is the
# kernel's plain version: the same function as the JAX package's
# ``models.rwkv.wkv_ref``.
wkv_ref = wkv6_ref


def wkv_chunked(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunk-sequential WKV on fp32 inputs. Within each chunk of length L:
        o_t = (r_t * prod_{s<=t-1} w) @ S_0
            + sum_{s<t} [sum_c r_t[c] k_s[c] e^{cum[t-1,c]-cum[s,c]}] v_s
            + (r_t . (u*k_t)) v_t
    with an explicit (L, L, dk) decay tensor per (b, h), masked before the
    product. A length ``chunk`` does not divide takes ``wkv_ref``.
    """
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if s % chunk != 0:
        return wkv_ref(r, k, v, w, u)
    n_chunks, L = s // chunk, chunk
    mask = (
        torch.arange(L, device=r.device)[:, None] > torch.arange(L, device=r.device)[None, :]
    )[None, :, :, None, None]
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for i in range(n_chunks):
        sl = slice(i * L, (i + 1) * L)
        r_t, k_t, v_t, w_t = r[:, sl], k[:, sl], v[:, sl], w[:, sl]  # (b, L, h, d)
        logw = torch.log(w_t)  # negative
        cum = torch.cumsum(logw, dim=1)  # cum[t] = sum_{s<=t} log w_s
        cum_prev = cum - logw  # cum[t-1] with cum[-1] = 0
        # inter-chunk: r decayed to chunk start
        o_inter = torch.einsum("blhk,bhkv->blhv", r_t * torch.exp(cum_prev), state)
        # intra-chunk: pairwise scores with per-channel decay
        decay_ts = torch.exp(cum_prev[:, :, None] - cum[:, None, :])  # (b, t, s, h, dk)
        scores = torch.einsum(
            "blhk,bmhk,blmhk->blmh", r_t, k_t, torch.where(mask, decay_ts, 0.0)
        )
        o_intra = torch.einsum("blmh,bmhv->blhv", scores, v_t)
        # diagonal bonus term
        diag = torch.einsum("blhk,hk,blhk->blh", r_t, u, k_t)
        outs.append(o_inter + o_intra + diag[..., None] * v_t)
        # state update to end of chunk
        k_dec = k_t * torch.exp(cum[:, -1:] - cum)
        state = torch.exp(cum[:, -1])[..., :, None] * state + torch.einsum(
            "blhk,blhv->bhkv", k_dec, v_t
        )
    return torch.cat(outs, dim=1), state


# ---------------------------------------------------------------------------
# Time-mix / channel-mix blocks
# ---------------------------------------------------------------------------


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x_{t-1}; the first position takes ``prev`` (decode carry) or zeros."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    return torch.cat([prev, x[:, :-1]], dim=1)


def _ddlerp(p: Params, x: torch.Tensor, x_prev: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Data-dependent token-shift interpolation giving the 5 mixed streams."""
    xx = (x_prev - x).float()
    x32 = x.float()
    base = x32 + xx * p["mu_x"]
    ax = split_at((None, "model"), (x.shape[-1], N_MIX * LORA_DIM_MIX))
    lora = ax.gather(torch.tanh(ax.copy(base) @ p["mix_w1"].float()))
    lora = lora.reshape(*lora.shape[:-1], N_MIX, LORA_DIM_MIX)
    delta = torch.einsum("bsnm,nmd->bsnd", lora, p["mix_w2"].float())  # (b,s,5,d)
    mixed = x32[:, :, None] + xx[:, :, None] * (p["mu"] + delta)
    # r,k,v,w,g streams in fresh rows of canonical strides: a strided
    # (b, s, d) stream, or at s = 1 one whose size-1 dim has an odd stride
    # (which ``.contiguous()`` keeps), makes each projection a batched
    # matmul that reads the weight once a sequence
    return mixed.permute(2, 0, 1, 3).clone(memory_format=torch.contiguous_format).unbind(0)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, h: int, eps: float = 64e-5) -> torch.Tensor:
    """Per-head layer norm of the wkv output (rwkv's ln_x)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, h, d // h).float()
    mean = xh.mean(dim=-1, keepdim=True)
    var = xh.var(dim=-1, unbiased=False, keepdim=True)
    xh = (xh - mean) * torch.rsqrt(var + eps)
    return (xh.reshape(b, s, d) * scale).to(x.dtype)


def tmix_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    kernel_mode: str = "kernel",
    chunk: int = 64,
    shift_prev: Optional[torch.Tensor] = None,
    s0: Optional[torch.Tensor] = None,
):
    """Time-mix of ``x`` (b, s, d). Returns ``(out, (shift, wkv_state))``:
    the last input row (the next call's token-shift carry) and the fp32
    ``(b, h, dk, dv)`` state after the last token."""
    h, hd = rwkv_dims(cfg)
    b, s, d = x.shape
    x_prev = _token_shift(x, shift_prev)
    xr, xk, xv, xw, xg = _ddlerp(p, x, x_prev)
    dt = x.dtype
    ax = split_at((None, "model"), (d, d))  # wr/wk/wv/wg columns, wo rows
    local = ax.size > 1 and split_at(("data", None, "model", None), (b, s, h, hd)).size > 1
    streams = zip((xr, xk, xv, xg), ("wr", "wk", "wv", "wg"))
    r, k, v, g = (ax.copy(t.to(dt)) @ p[n] for t, n in streams)
    if not local:  # the whole heads from the ranks' columns
        r, k, v, g = (ax.gather(t) for t in (r, k, v, g))
    g = F.silu(g)
    # data-dependent decay (fp32)
    decay_lora = torch.tanh(xw @ p["decay_w1"].float()) @ p["decay_w2"].float()
    w = torch.exp(-torch.exp(p["decay_base"] + decay_lora))  # (b, s, d) in (0,1)
    u, ln_x = p["bonus"].float(), p["ln_x"]
    if local:  # the rank's heads of what every rank computes whole
        w, u, ln_x, h = ax.split(w), ax.split(u, 0), ax.split(ln_x), h // ax.size

    def heads(t):
        return t.reshape(b, s, h, hd).float()

    r4, k4, v4, w4 = heads(r), heads(k), heads(v), heads(w)
    if kernel_mode == "kernel":
        o, s_final = wkv_ops.wkv6(r4, k4, v4, w4, u, chunk=chunk, s0=s0, ragged=True)
    elif s == 1:
        o, s_final = wkv_ref(r4, k4, v4, w4, u, s0)
    else:
        o, s_final = wkv_chunked(r4, k4, v4, w4, u, chunk=chunk)
    o = _group_norm(o.reshape(b, s, h * hd).to(dt), ln_x, h) * g
    return ax.reduce((o if local else ax.split(o)) @ p["wo"]), (x[:, -1:], s_final)


def cmix_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,
    *,
    shift_prev: Optional[torch.Tensor] = None,
):
    """Channel-mix of ``x`` (b, s, d). Returns ``(out, shift)``."""
    x_prev = _token_shift(x, shift_prev)
    xx = (x_prev - x).float()
    x32 = x.float()
    xk = (x32 + xx * p["mu_k"]).to(x.dtype)
    xr = (x32 + xx * p["mu_r"]).to(x.dtype)
    d = x.shape[-1]
    ax = split_at((None, "model"), (d, cfg.d_ff))  # wk columns, wv rows
    kv = ax.reduce(torch.square(torch.relu(ax.copy(xk) @ p["wk"])) @ p["wv"])
    ax = split_at((None, "model"), (d, d))  # wr columns
    out = torch.sigmoid(ax.gather(ax.copy(xr) @ p["wr"])) * kv
    return out, x[:, -1:]


def rwkv_init_state(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device: torch.device
) -> Dict[str, torch.Tensor]:
    """The recurrent cache: shifts ``(L, b, 1, d)`` in ``dtype``, wkv states
    ``(L, b, h, dk, dv)`` in fp32."""
    h, hd = rwkv_dims(cfg)
    shift = (cfg.n_layers, batch, 1, cfg.d_model)
    return {
        "tmix_shift": torch.zeros(shift, dtype=dtype, device=device),
        "cmix_shift": torch.zeros(shift, dtype=dtype, device=device),
        "wkv": torch.zeros((cfg.n_layers, batch, h, hd, hd), dtype=torch.float32, device=device),
    }
