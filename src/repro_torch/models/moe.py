"""Mixture-of-Experts FFN: top-k token-choice routing with capacity-bounded
sort-based dispatch (the JAX package's ``models/moe.py``).

Tokens are split into groups; routing, the stable sort and the capacity
are per group. Each group's kept assignments are gathered into an
``(experts, capacity, d)`` block, the experts run as one batched matmul
over the experts, and each assignment's slot output is gathered back and
weighted by its gate. An assignment past its expert's capacity is
dropped: it contributes nothing. The JAX package's sharding constraints
(``constrain``) are left out: they do nothing on one device.

``moe_reference`` is the dense oracle (every expert computed, gated sum)
that the tests hold the dispatch against.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import Params, dense_init


def _experts_init(
    gen: torch.Generator, n_experts: int, in_dim: int, out_dim: int, dtype: torch.dtype,
    lead: Tuple[int, ...],
) -> torch.Tensor:
    """``lead + (n_experts, in_dim, out_dim)`` weights, drawn one leading
    index at a time, so that no more than one layer's experts are ever
    held in fp32 at once."""
    out = torch.empty(*lead, n_experts, in_dim, out_dim, dtype=dtype, device=gen.device)
    for w in out.view(-1, n_experts, in_dim, out_dim):
        w.copy_(dense_init(gen, in_dim, out_dim, dtype, (n_experts,)))
    return out


def moe_init(
    gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype, lead: Tuple[int, ...] = ()
) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, d, e, torch.float32, lead),  # router kept fp32
        "w_gate": _experts_init(gen, e, d, f, dtype, lead),
        "w_up": _experts_init(gen, e, d, f, dtype, lead),
        "w_down": _experts_init(gen, e, f, d, dtype, lead),
    }


def default_capacity(group_size: int, top_k: int, n_experts: int, factor: float = 1.25) -> int:
    cap = int(group_size * top_k / n_experts * factor)
    cap = max(cap, top_k)  # never below top_k so tiny groups still route
    return -(-cap // 8) * 8  # rounded up to a multiple of 8


# ---------------------------------------------------------------------------
# Routing (shared by dispatch + oracle)
# ---------------------------------------------------------------------------


def route(router_w: torch.Tensor, x: torch.Tensor, top_k: int):
    """x: (..., d) -> (gate_vals (..., k) fp32, expert_idx (..., k) int32,
    router probs (..., E) fp32 for the aux loss). The router is upcast to
    fp32 (the model casts it to the compute dtype with the other leaves;
    JAX's einsum promotes it). Ties go to the lower expert index, as in
    ``jax.lax.top_k``: a stable descending sort."""
    logits = x.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = vals[..., :top_k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True), min=1e-9)
    return gate_vals, idx[..., :top_k].to(torch.int32), probs


def load_balance_loss(probs: torch.Tensor, expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum_e f_e * p_e, with f_e the
    assignments to expert e a token and p_e its mean router probability."""
    n_tokens = probs.numel() // n_experts
    counts = torch.bincount(expert_idx.reshape(-1).long(), minlength=n_experts)
    f = counts.float() / n_tokens
    p = probs.reshape(-1, n_experts).mean(dim=0)
    return n_experts * torch.sum(f * p)


# ---------------------------------------------------------------------------
# Sort-based capacity dispatch (per group)
# ---------------------------------------------------------------------------


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int, capacity: int):
    """Routing tables of each group.

    expert_idx: (..., S, k) integer, leading dims one group each. Returns
    int32:
      slot_table: (..., E, C) — flat (s*k+j) id occupying each expert slot,
                  sentinel S*k when empty;
      slot_of_flat: (..., S*k) — flat slot id (e*C + c) of each assignment,
                  sentinel E*C when dropped (capacity overflow).
    Within an expert, slots go to assignments in flat order (a stable
    sort), and those past ``capacity`` are dropped.
    """
    *lead, s, k = expert_idx.shape
    n_flat, n_slots = s * k, n_experts * capacity
    flat = expert_idx.reshape(-1, n_flat).long()  # (G, S*k)
    n_groups = flat.shape[0]
    dev = flat.device
    order = torch.argsort(flat, dim=-1, stable=True)  # token order kept per expert
    sorted_expert = torch.gather(flat, 1, order)
    group_base = n_experts * torch.arange(n_groups, device=dev)[:, None]
    counts = torch.bincount((flat + group_base).reshape(-1), minlength=n_groups * n_experts)
    counts = counts.view(n_groups, n_experts)
    offsets = torch.cumsum(counts, dim=-1) - counts
    pos_in_expert = torch.arange(n_flat, device=dev) - torch.gather(offsets, 1, sorted_expert)
    keep = pos_in_expert < capacity
    # dropped assignments go to slot n_slots, a spare column cut off after
    flat_slot = torch.where(keep, sorted_expert * capacity + pos_in_expert, n_slots)
    table = torch.full((n_groups, n_slots + 1), n_flat, dtype=torch.long, device=dev)
    table.scatter_(1, flat_slot, order)
    slot_table = table[:, :n_slots].reshape(*lead, n_experts, capacity)
    slot_of_flat = torch.empty_like(flat_slot).scatter_(1, order, flat_slot)
    return slot_table.to(torch.int32), slot_of_flat.reshape(*lead, n_flat).to(torch.int32)


def _activation(gate: torch.Tensor, act: str) -> torch.Tensor:
    if act == "silu":
        return F.silu(gate)
    if act == "gelu":
        return F.gelu(gate, approximate="tanh")
    raise ValueError(f"unknown activation {act}")


def _expert_ffn(p: Params, h: torch.Tensor, act: str) -> torch.Tensor:
    """h: (g, e, c, d) -> (g, e, c, d): each expert's gated MLP on its
    slots, as one batched matmul over the experts, (e, g·c, d) @ (e, d, f)."""
    g, e, c, d = h.shape
    x = h.transpose(0, 1).reshape(e, g * c, d)
    gate = _activation(torch.bmm(x, p["w_gate"]), act)
    out = torch.bmm(gate * torch.bmm(x, p["w_up"]), p["w_down"])
    return out.reshape(e, g, c, d).transpose(0, 1)


def _moe_groups(
    p: Params, cfg: ArchConfig, xg: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dispatch + expert FFN + combine for a block of groups.
    xg: (g, g_size, d) -> (output (g, g_size, d), aux)."""
    n_groups, g_size, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    gate_vals, expert_idx, probs = route(p["router"], xg, k)
    aux = load_balance_loss(probs, expert_idx, e)
    slot_table, slot_of_flat = _dispatch_indices(expert_idx, e, cap)
    rows = torch.arange(n_groups, device=xg.device)

    # gather expert inputs: the sentinel row is zeros
    x_pad = torch.cat([xg, xg.new_zeros(n_groups, 1, d)], dim=1)
    slot_table = slot_table.long()
    tok_idx = torch.where(slot_table < g_size * k, slot_table // k, g_size)
    expert_in = x_pad[rows[:, None, None], tok_idx]  # (g, e, c, d)
    expert_out = _expert_ffn(p, expert_in, cfg.gated_act)

    # combine: gather each assignment's slot output, weight by its gate
    out_flat = expert_out.reshape(n_groups, e * cap, d)
    out_pad = torch.cat([out_flat, out_flat.new_zeros(n_groups, 1, d)], dim=1)
    contrib = out_pad[rows[:, None], slot_of_flat.long()]
    contrib = contrib.reshape(n_groups, g_size, k, d)
    y = torch.sum(contrib * gate_vals[..., None].to(contrib.dtype), dim=2)
    return y, aux


def moe_apply(
    p: Params,
    cfg: ArchConfig,
    x: torch.Tensor,  # (b, s, d)
    *,
    group_size: int = 4096,
    capacity_factor: float = 1.25,
    max_groups_per_block: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (b, s, d), aux load-balance loss, an fp32 scalar).

    The group size is the largest divisor of the token count that is at
    most ``group_size``. More than ``max_groups_per_block`` groups, when
    that many divide them, run a block at a time (the JAX package's
    ``lax.scan`` over blocks, bounding the live dispatch tensors); the aux
    loss is then the mean of the blocks' aux losses.
    """
    b, s, d = x.shape
    tokens = b * s
    g_size = min(group_size, tokens)
    while tokens % g_size:  # largest divisor of the token count <= group_size
        g_size -= 1
    n_groups = tokens // g_size
    xg = x.reshape(n_groups, g_size, d)
    cap = default_capacity(g_size, cfg.top_k, cfg.n_experts, capacity_factor)

    if n_groups <= max_groups_per_block or n_groups % max_groups_per_block:
        y, aux = _moe_groups(p, cfg, xg, cap)
        return y.reshape(b, s, d), aux

    ys, auxs = [], []
    for i in range(0, n_groups, max_groups_per_block):
        y, aux = _moe_groups(p, cfg, xg[i : i + max_groups_per_block], cap)
        ys.append(y)
        auxs.append(aux)
    return torch.cat(ys).reshape(b, s, d), torch.stack(auxs).mean()


# ---------------------------------------------------------------------------
# Dense oracle (tests): every expert computed, gated combination
# ---------------------------------------------------------------------------


def moe_reference(p: Params, cfg: ArchConfig, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gate_vals, expert_idx, probs = route(p["router"], x, cfg.top_k)
    aux = load_balance_loss(probs, expert_idx, cfg.n_experts)
    outs = []
    for e in range(cfg.n_experts):
        gate = _activation(x @ p["w_gate"][e], cfg.gated_act)
        outs.append((gate * (x @ p["w_up"][e])) @ p["w_down"][e])
    stacked = torch.stack(outs, dim=2)  # (b, s, E, d)
    onehot = F.one_hot(expert_idx.long(), cfg.n_experts).float()
    w_full = torch.sum(onehot * gate_vals[..., None], dim=-2)  # (b, s, E)
    y = torch.einsum("bse,bsed->bsd", w_full.to(stacked.dtype), stacked)
    return y, aux
