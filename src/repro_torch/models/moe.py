"""Mixture-of-Experts FFN: top-k token-choice routing with capacity-bounded
sort-based dispatch (the JAX package's ``models/moe.py``).

Tokens are split into groups; routing, the stable sort and the capacity
are per group. Each group's kept assignments are gathered into an
``(experts, capacity, d)`` block, the experts run as one batched matmul
over the experts, and each assignment's slot output is gathered back and
weighted by its gate. An assignment past its expert's capacity is
dropped: it contributes nothing.

On a model axis (``dist.api``) the experts are split over it where the
guard lets them (JAX's ``("data", "expert", None, None)`` on the dispatch
block): every rank routes the same tokens, so routing, capacity drops
and the aux loss are unchanged; a rank runs only its experts' slots, and
the combine, each token's gated sum over its experts, is all-reduced.

On a data mesh (a sharding context whose mesh splits rows over several
data ranks, ``dist.api.current()``), each rank holds its rows of the call
and ``moe_apply`` takes the reference's global semantics, those of JAX's
GSPMD step over the global microbatch: the group size and capacity come
from the global token count, laid out in rank order; a group that spans
ranks gives each rank's assignments their queue position after the
per-expert counts of the earlier ranks in the group (an exclusive prefix
over the ranks' ``(groups, E)`` counts, one all-reduce), so capacity
drops fall in global token order; and the aux loss takes ``f`` and ``p``
summed over the data ranks. Only ``(groups, E)`` counts cross ranks.

``moe_reference`` is the dense oracle (every expert computed, gated sum)
that the tests hold the dispatch against.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import current, data_axes, split_at
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


def _dispatch_indices(
    expert_idx: torch.Tensor, n_experts: int, capacity: int, base: Optional[torch.Tensor] = None
):
    """Routing tables of each group.

    expert_idx: (..., S, k) integer, leading dims one group each. Returns
    int32:
      slot_table: (..., E, C) — flat (s*k+j) id occupying each expert slot,
                  sentinel S*k when empty;
      slot_of_flat: (..., S*k) — flat slot id (e*C + c) of each assignment,
                  sentinel E*C when dropped (capacity overflow).
    Within an expert, slots go to assignments in flat order (a stable
    sort), and those past ``capacity`` are dropped. ``base`` (G, E): the
    assignments each group's expert already holds ahead of these (a group
    spanning data ranks: the earlier ranks'); an assignment is then kept
    while ``base`` plus its position is under ``capacity``.
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
    room = capacity if base is None else capacity - torch.gather(base.long(), 1, sorted_expert)
    keep = pos_in_expert < room
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
    gate_vals, expert_idx, probs = route(p["router"], xg, cfg.top_k)
    aux = load_balance_loss(probs, expert_idx, cfg.n_experts)
    return _dispatch_combine(p, cfg, xg, gate_vals, expert_idx, cap), aux


def _dispatch_combine(
    p: Params, cfg: ArchConfig, xg: torch.Tensor, gate_vals: torch.Tensor,
    expert_idx: torch.Tensor, cap: int, base: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The routed groups' output: xg (g, g_size, d) -> (g, g_size, d);
    ``base`` as in ``_dispatch_indices``."""
    n_groups, g_size, d = xg.shape
    e, k = cfg.n_experts, cfg.top_k
    slot_table, slot_of_flat = _dispatch_indices(expert_idx, e, cap, base)
    slot_table, slot_of_flat = slot_table.long(), slot_of_flat.long()
    ax = split_at(("data", "expert", None, None), (n_groups, e, cap, d))
    if ax.size > 1:  # the rank's experts' slots; the others' are the sentinel
        e //= ax.size
        xg, gate_vals = ax.copy(xg), ax.copy(gate_vals)
        slot_table = slot_table[:, ax.rank * e : (ax.rank + 1) * e]
        slot_of_flat = slot_of_flat - ax.rank * e * cap
        slot_of_flat = torch.where((slot_of_flat >= 0) & (slot_of_flat < e * cap),
                                   slot_of_flat, e * cap)
    rows = torch.arange(n_groups, device=xg.device)

    # gather expert inputs: the sentinel row is zeros
    x_pad = torch.cat([xg, xg.new_zeros(n_groups, 1, d)], dim=1)
    tok_idx = torch.where(slot_table < g_size * k, slot_table // k, g_size)
    expert_in = x_pad[rows[:, None, None], tok_idx]  # (g, e, c, d)
    expert_out = _expert_ffn(p, expert_in, cfg.gated_act)

    # combine: gather each assignment's slot output, weight by its gate
    out_flat = expert_out.reshape(n_groups, e * cap, d)
    out_pad = torch.cat([out_flat, out_flat.new_zeros(n_groups, 1, d)], dim=1)
    contrib = out_pad[rows[:, None], slot_of_flat]
    contrib = contrib.reshape(n_groups, g_size, k, d)
    return ax.reduce(torch.sum(contrib * gate_vals[..., None].to(contrib.dtype), dim=2))


def _group_size(tokens: int, group_size: int) -> int:
    """The largest divisor of the token count that is at most ``group_size``."""
    g_size = min(group_size, tokens)
    while tokens % g_size:
        g_size -= 1
    return g_size


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
    loss is then the mean of the blocks' aux losses. On a data mesh the
    token count is the global one (module docstring).
    """
    split = _data_split()
    if split is not None:
        return _moe_apply_global(p, cfg, x, split, group_size, capacity_factor,
                                 max_groups_per_block)
    b, s, d = x.shape
    tokens = b * s
    g_size = _group_size(tokens, group_size)
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
# On a data mesh: the global microbatch's groups and aux loss
# ---------------------------------------------------------------------------


class _DataSplit:
    """The data ranks a call's rows are split over: their process groups
    (one a data axis of more than one rank), this rank's index over them
    (row-major in the mesh's axis order, as the batch is laid out), and
    their number."""

    def __init__(self, groups: List, index: int, ranks: int):
        self.groups, self.index, self.ranks = groups, index, ranks

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the data ranks, in place."""
        for g in self.groups:
            dist.all_reduce(t, group=g)
        return t


def _data_split() -> Optional[_DataSplit]:
    """The active context's data ranks, or None: no context, a mesh that
    is not a ``DeviceMesh``, or one data rank."""
    ctx = current()
    mesh = getattr(ctx, "mesh", None)
    if not isinstance(mesh, DeviceMesh):
        return None
    axes = [i for i in data_axes(mesh) if mesh.size(i) > 1]
    if not axes:
        return None
    coord = mesh.get_coordinate()
    index = 0
    for i in axes:
        index = index * mesh.size(i) + coord[i]
    return _DataSplit([mesh.get_group(i) for i in axes], index,
                      math.prod(mesh.size(i) for i in axes))


def _moe_apply_global(
    p: Params, cfg: ArchConfig, x: torch.Tensor, split: _DataSplit, group_size: int,
    capacity_factor: float, max_groups_per_block: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` on this rank's rows ``x`` of a call whose tokens are
    split over ``split``'s ranks in rank order. The rank's tokens are cut
    into pieces, each within one global group (a whole group, or the
    rank's share of one that spans ranks); a rank boundary inside a group
    that is not a whole number of ranks' tokens is refused."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    local = b * s
    tokens = split.ranks * local
    g_size = _group_size(tokens, group_size)
    n_groups = tokens // g_size
    cap = default_capacity(g_size, k, e, capacity_factor)
    piece = min(g_size, local)
    if g_size % piece or local % piece:
        raise ValueError(f"MoE groups of {g_size} tokens cut a data rank's {local} tokens "
                         f"off a group boundary")
    n_pieces = local // piece
    dev = x.device
    gid = (split.index * local + piece * torch.arange(n_pieces, device=dev)) // g_size
    xg = x.reshape(n_pieces, piece, d)
    gate_vals, expert_idx, probs = route(p["router"], xg, k)

    # one all-reduce: each rank's (group, expert) counts in its own row,
    # and the router probabilities summed over each group's tokens
    rows = torch.arange(n_pieces, device=dev)[:, None] * e
    counts = torch.bincount((expert_idx.reshape(n_pieces, -1).long() + rows).reshape(-1),
                            minlength=n_pieces * e).view(n_pieces, e)
    p_sum = probs.sum(dim=1)  # (pieces, E)
    buf = torch.zeros(split.ranks + 1, n_groups, e, dtype=torch.float64, device=dev)
    buf[split.index, gid] = counts.double()
    buf[split.ranks, gid] = p_sum.detach().double()
    split.all_reduce(buf)
    by_rank, p_all = buf[: split.ranks], buf[split.ranks].float()
    base = by_rank[: split.index, gid].sum(dim=0)  # the earlier ranks' counts

    ys = [_dispatch_combine(p, cfg, xg[i : i + max_groups_per_block],
                            gate_vals[i : i + max_groups_per_block],
                            expert_idx[i : i + max_groups_per_block], cap,
                            base[i : i + max_groups_per_block])
          for i in range(0, n_pieces, max_groups_per_block)]

    # aux: E * sum_e f_e p_e over each block's global tokens. p_all's value
    # with this rank's share differentiable and scaled by the rank count:
    # the step averages gradients over the data ranks, so the mean of the
    # ranks' shares is the gradient of the global sum
    mine = torch.zeros(n_groups, e, dtype=torch.float32, device=dev).index_add(0, gid, p_sum)
    p_all = p_all + split.ranks * (mine - mine.detach())
    f_all = by_rank.sum(dim=0).float()
    block = max_groups_per_block
    if n_groups <= block or n_groups % block:
        block = n_groups
    f_b = f_all.view(-1, block, e).sum(dim=1) / (block * g_size)
    p_b = p_all.view(-1, block, e).sum(dim=1) / (block * g_size)
    aux = (e * torch.sum(f_b * p_b, dim=-1)).mean()
    return torch.cat(ys).reshape(b, s, d), aux


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
