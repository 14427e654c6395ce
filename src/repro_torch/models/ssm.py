"""Mamba-style selective SSM branch: hymba's parallel SSM heads (the JAX
package's ``models/ssm.py``).

The recurrence (diagonal A, per-channel dt), state h: (c, n) fp32:
    h_t = exp(dt_t * A) . h_{t-1} + dt_t * B_t x_t
    y_t = <h_t, C_t> + D * x_t

Paths, one math:
  * ``ssm_scan_ref``     — step by step (the oracle, and the fallback of
                           the chunked scan),
  * ``ssm_scan_chunked`` — sequential over chunks, parallel within one:
                           JAX runs ``lax.associative_scan`` there;
                           PyTorch has none, so the same combine runs as
                           a doubling (Hillis-Steele) scan, log2(chunk)
                           passes over the chunk,
  * ``ssm_decode``       — one token, from the conv window and h.

The JAX package has no kernel for this scan (it is plain jnp), and neither
has the port: it runs in plain PyTorch on every device.

On a model axis (``dist.api``; JAX's ``("data", None, "model")`` on the
input projection) the inner channels are split where the guard lets them
(``_in_proj``): ``in_proj``'s column pieces are all-gathered and each
rank keeps its channels of ``x`` and ``z``, the conv, ``dt_proj``,
``a_log``, the scan and the state run on them, ``x_proj`` and
``out_proj`` are row-parallel and all-reduced.

``jax.nn.softplus`` has no threshold, where ``F.softplus`` returns ``x``
above 20. The exact value there exceeds ``x`` by ``log1p(exp(-x))``,
under 2.1e-9, below half an fp32 ulp of 20 (9.5e-7), so the two agree
in fp32 above it and differ by rounding below it. ``softplus`` here is
JAX's formula, ``max(x, 0) + log1p(exp(-|x|))``, so nothing differs.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import ModelAxis, split_at
from repro_torch.models.layers import Params, dense_init


def ssm_dims(cfg: ArchConfig) -> Tuple[int, int, int]:
    """(d_inner, dt_rank, state size n)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    dt_rank = max(1, math.ceil(cfg.d_model / 16))
    return d_inner, dt_rank, cfg.ssm_state


def ssm_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, lead: Tuple[int, ...] = ()
) -> Params:
    """The branch's params; ``a_log``, ``dt_bias`` and ``d_skip`` are fp32
    whatever ``dtype`` is, as in the JAX package."""
    d_inner, dt_rank, n = ssm_dims(cfg)
    f32, dev = torch.float32, gen.device
    a = torch.arange(1, n + 1, dtype=f32, device=dev).expand(*lead, d_inner, n)
    dt = torch.full((*lead, d_inner), 0.01, dtype=f32, device=dev)
    conv_w = torch.randn(*lead, cfg.ssm_conv, d_inner, generator=gen, device=dev)
    return {
        "in_proj": dense_init(gen, cfg.d_model, 2 * d_inner, dtype, lead),
        "conv_w": conv_w.mul_(0.1).to(dtype),
        "conv_b": torch.zeros(*lead, d_inner, dtype=dtype, device=dev),
        "x_proj": dense_init(gen, d_inner, dt_rank + 2 * n, dtype, lead),
        "dt_proj": dense_init(gen, dt_rank, d_inner, dtype, lead),
        "dt_bias": torch.log(torch.expm1(dt)),  # softplus⁻¹(0.01)
        "a_log": torch.log(a),
        "d_skip": torch.ones(*lead, d_inner, dtype=f32, device=dev),
        "out_proj": dense_init(gen, d_inner, cfg.d_model, dtype, lead),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``log(1 + exp(x))`` with no threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over the sequence, fp32 sums. x: (b, s, c),
    w: (k, c); output in ``x.dtype``."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i : i + s].float() * w[i].float()
    return (out + b.float()).to(x.dtype)


def _in_proj(p: Params, cfg: ArchConfig, xin: torch.Tensor):
    """``(x, z, ax)``: the input projection's halves (b, s, c), the rank's
    channels where ``ax``, the model axis, splits them, else whole."""
    d_inner = ssm_dims(cfg)[0]
    ax = split_at(("data", None, "model"), (*xin.shape[:2], 2 * d_inner))
    x, z = ax.gather(ax.copy(xin) @ p["in_proj"]).chunk(2, dim=-1)
    ax = split_at(("data", None, "model"), (*xin.shape[:2], d_inner))
    return ax.split(x), ax.split(z), ax


def _ssm_inputs(p: Params, cfg: ArchConfig, x: torch.Tensor, ax: ModelAxis):
    """The pre-scan computation from the input projection's ``x`` half:
    (x, dt fp32, B fp32, C fp32, A fp32-or-compute, < 0)."""
    _, dt_rank, n = ssm_dims(cfg)
    x = F.silu(_causal_conv(x, p["conv_w"], p["conv_b"]))
    proj = ax.copy(ax.reduce(x @ p["x_proj"]))  # row-parallel; every rank's channels read it
    dt_in, b_in, c_in = proj.split([dt_rank, n, n], dim=-1)
    dt = softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])  # (b, s, c) fp32
    a = -torch.exp(p["a_log"])  # (c, n)
    return x, dt, b_in.float(), c_in.float(), a


def ssm_scan_ref(
    dt: torch.Tensor,  # (b, s, c) fp32
    a: torch.Tensor,  # (c, n), negative
    b_in: torch.Tensor,  # (b, s, n)
    c_in: torch.Tensor,  # (b, s, n)
    x: torch.Tensor,  # (b, s, c)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential oracle, from a zero state: (y (b, s, c) fp32,
    h_final (b, c, n) fp32)."""
    bsz, s, c = dt.shape
    h = torch.zeros(bsz, c, a.shape[1], device=dt.device)
    ys = []
    for t in range(s):
        dt_t = dt[:, t]
        decay = torch.exp(dt_t[..., None] * a)  # (b, c, n)
        h = decay * h + (dt_t * x[:, t].float())[..., None] * b_in[:, t, None, :]
        ys.append(torch.einsum("bcn,bn->bc", h, c_in[:, t]))
    y = torch.stack(ys, dim=1) if ys else torch.zeros(bsz, 0, c, device=dt.device)
    return y, h


def _doubling_scan(
    dt: torch.Tensor, a: torch.Tensor, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the pairs ``(dt_t a, u_t)`` under JAX's
    combine ``(la, lb) . (ra, rb) = (la + ra, exp(ra) lb + rb)``, by
    doubling: after the pass at distance ``d`` each position holds the
    combine of the ``2 d`` positions up to it. ``dt`` (b, L, c) > 0, ``a``
    (c, n) < 0, ``u`` (b, L, c, n). A is the same at every step, so a
    window's log decay ``sum(dt_t a)`` is ``sum(dt_t) a``: the left half
    of the pair is carried as the window sums of ``dt``, n times smaller.
    Returns (``cumsum(dt)`` (b, L, c), the scanned ``u``). Every exponent
    is a sum of ``dt`` times ``a``, so none is positive."""
    length, d = u.shape[1], 1
    while d < length:
        decay = torch.exp(dt[:, d:, :, None] * a)
        u = torch.cat([u[:, :d], torch.addcmul(u[:, d:], decay, u[:, :-d])], dim=1)
        dt = torch.cat([dt[:, :d], dt[:, d:] + dt[:, :-d]], dim=1)
        d *= 2
    return dt, u


def ssm_scan_chunked(
    dt: torch.Tensor,
    a: torch.Tensor,
    b_in: torch.Tensor,
    c_in: torch.Tensor,
    x: torch.Tensor,
    *,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential over ``s / chunk`` chunks, each scanned in parallel
    (``_doubling_scan``) from the carried state; the oracle when
    ``chunk`` does not divide ``s``, as in the JAX package. The same
    recurrence as ``ssm_scan_ref``, fp32 state, summed in another order."""
    bsz, s, c = dt.shape
    if s % chunk:
        return ssm_scan_ref(dt, a, b_in, c_in, x)
    h = torch.zeros(bsz, c, a.shape[1], device=dt.device)
    ys = []
    for i in range(0, s, chunk):
        dt_t = dt[:, i : i + chunk]
        u = (dt_t * x[:, i : i + chunk].float())[..., None] * b_in[:, i : i + chunk, None, :]
        cum_dt, h_scan = _doubling_scan(dt_t, a, u)
        h_all = h_scan + torch.exp(cum_dt[..., None] * a) * h[:, None]  # fold in the carry
        ys.append(torch.einsum("blcn,bln->blc", h_all, c_in[:, i : i + chunk]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h


def ssm_apply(
    p: Params, cfg: ArchConfig, xin: torch.Tensor, *, chunk: int = 128,
    return_state: bool = False,
):
    """The branch over a full sequence (train / prefill), ``xin`` (b, s,
    d_model). With ``return_state`` also ``(h_final (b, c, n) fp32, conv
    state)``: the last ``ssm_conv - 1`` pre-conv inputs, or all ``s`` of
    them when the prompt is shorter, as the JAX package keeps them."""
    x_in, z, ax = _in_proj(p, cfg, xin)
    x, dt, b_in, c_in, a = _ssm_inputs(p, cfg, x_in, ax)
    y, h_final = ssm_scan_chunked(dt, a, b_in, c_in, x, chunk=chunk)
    y = y + p["d_skip"] * x.float()
    y = (y * F.silu(z.float())).to(xin.dtype)
    out = ax.reduce(y @ p["out_proj"])
    if return_state:
        return out, (h_final, x_in[:, -(cfg.ssm_conv - 1):])
    return out


# ---------------------------------------------------------------------------
# Decode (recurrent state: the conv window and h)
# ---------------------------------------------------------------------------


def ssm_init_state(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device: torch.device
) -> Dict[str, torch.Tensor]:
    """``conv`` (n_layers, b, ssm_conv - 1, d_inner) in ``dtype`` and ``h``
    (n_layers, b, d_inner, n) fp32, zeros."""
    d_inner, _, n = ssm_dims(cfg)
    return {
        "conv": torch.zeros(cfg.n_layers, batch, cfg.ssm_conv - 1, d_inner, dtype=dtype,
                            device=device),
        "h": torch.zeros(cfg.n_layers, batch, d_inner, n, dtype=torch.float32, device=device),
    }


def ssm_decode(
    p: Params, cfg: ArchConfig, xin: torch.Tensor, state: Dict[str, torch.Tensor]
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token ``xin`` (b, 1, d_model) against this layer's state
    ``{"conv": (b, k - 1, c), "h": (b, c, n)}``; returns (out (b, 1,
    d_model), new state)."""
    _, dt_rank, n = ssm_dims(cfg)
    x_new, z, ax = _in_proj(p, cfg, xin)  # (b, 1, c)
    window = torch.cat([state["conv"], x_new], dim=1)  # (b, k, c)
    x = torch.einsum("bkc,kc->bc", window.float(), p["conv_w"].float()) + p["conv_b"].float()
    x = F.silu(x).to(xin.dtype)[:, None, :]  # (b, 1, c)
    proj = ax.copy(ax.reduce(x @ p["x_proj"]))
    dt_in, b_in, c_in = proj.split([dt_rank, n, n], dim=-1)
    dt = softplus((dt_in @ p["dt_proj"]).float() + p["dt_bias"])[:, 0]  # (b, c)
    a = -torch.exp(p["a_log"])
    decay = torch.exp(dt[..., None] * a)  # (b, c, n)
    h = decay * state["h"] + (dt * x[:, 0].float())[..., None] * b_in.float()[:, 0, None, :]
    y = torch.einsum("bcn,bn->bc", h, c_in.float()[:, 0])
    y = y + p["d_skip"] * x[:, 0].float()
    y = (y * F.silu(z[:, 0].float())).to(xin.dtype)
    return ax.reduce(y @ p["out_proj"])[:, None, :], {"conv": window[:, 1:], "h": h}
