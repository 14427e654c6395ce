"""AdamW with a warmup-cosine schedule and global-norm clipping (the JAX
package's ``train/optimizer.py``).

The state is ``{"m": tree, "v": tree, "step": int64 tensor}``, m and v
mirroring the param tree in ``state_dtype``. Where JAX returns new arrays,
``AdamW.update`` writes params, m and v in place, under ``torch.no_grad``:
at full width a second copy of params and moments would not fit beside
them. It returns the same (now updated) trees, so a caller may use it as
the functional form. The arithmetic follows the JAX update step for step:
the schedule at ``step + 1``, clipping by the fp32 global norm with the
scale applied in fp32 and cast back to each gradient's dtype, bias
corrections ``1 - b ** step`` in fp32, and weight decay on every leaf with
two or more dimensions (the stacked per-layer norm scales included).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import _pytree as pytree

Pytree = Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    state_dtype: str = "float32"


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def cosine_lr(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup to ``lr``, then a cosine down to ``min_lr_ratio *
    lr``; fp32 throughout, as the JAX schedule."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def sum_of_squares(t: torch.Tensor) -> torch.Tensor:
    """A leaf's fp32 sum of squares: one fp32 dot product of the flattened
    leaf with itself, no leaf-sized temporary."""
    x = t.float().reshape(-1)
    return torch.dot(x, x)


def norm_of_squares(squares) -> torch.Tensor:
    """sqrt of the sum of per-leaf sums of squares, added in leaf order."""
    total = None
    for sq in squares:
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


def global_norm(tree: Pytree) -> torch.Tensor:
    """sqrt of the sum of every leaf's fp32 sum of squares (a 0-d fp32
    tensor on the leaves' device)."""
    return norm_of_squares(sum_of_squares(t) for t in pytree.tree_leaves(tree))


def clip_by_global_norm(tree: Pytree, max_norm: float) -> Tuple[Pytree, torch.Tensor]:
    """Each leaf times ``min(1, max_norm / max(norm, 1e-9))``, in fp32 and
    cast back to its dtype; returns (clipped tree, norm)."""
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return pytree.tree_map(lambda g: (g.float() * scale).to(g.dtype), tree), norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


class AdamW:
    """AdamW over a tree of tensors; ``update`` writes in place."""

    def __init__(self, cfg: Optional[AdamWConfig] = None):
        self.cfg = cfg or AdamWConfig()

    def state_bytes(self, params: Pytree) -> int:
        """Bytes ``init(params)`` allocates (m and v in ``state_dtype`` and
        the step), computed without allocating them."""
        size = torch.empty((), dtype=getattr(torch, self.cfg.state_dtype)).element_size()
        return 2 * size * sum(p.numel() for p in pytree.tree_leaves(params)) + 8

    def update_temp_bytes(self, params: Pytree) -> int:
        """The largest transient ``update`` allocates beyond the gradients:
        three fp32 temporaries of the largest piece it updates at once (runs
        of a leaf's rows, at most ``PIECE_ELEMENTS``), plus fp32 copies of
        that piece's gradient and moments when they are not fp32."""
        state_f32 = self.cfg.state_dtype == "float32"
        worst = 0
        for p in pytree.tree_leaves(params):
            piece = p.numel() if p.dim() == 0 else min(p.shape[0], _rows_a_piece(p)) * p[0].numel()
            copies = 3 + (0 if p.dtype == torch.float32 else 2) + (0 if state_f32 else 2)
            worst = max(worst, 4 * copies * piece)
        return worst

    def init(self, params: Pytree) -> Dict:
        dt = getattr(torch, self.cfg.state_dtype)
        zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
        device = pytree.tree_leaves(params)[0].device
        return {
            "m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int64, device=device),
        }

    @torch.no_grad()
    def update(self, grads: Pytree, state: Dict, params: Pytree,
               grad_norm: Optional[torch.Tensor] = None) -> Tuple[Pytree, Dict, Dict]:
        """One step: returns ``(params, state, metrics)``, params and
        ``state``'s m, v and step updated in place. ``grads`` may be
        overwritten (clipped in place). ``grad_norm``: the global norm
        when the trees are this rank's shards of larger ones (the step on
        a mesh); otherwise the norm of ``grads``."""
        cfg = self.cfg
        state["step"] += 1
        step = state["step"]
        lr = cosine_lr(cfg, step)
        leaves = [pytree.tree_leaves(t) for t in (params, grads, state["m"], state["v"])]
        if len({len(ts) for ts in leaves}) != 1 or any(
            len({t.shape for t in ts}) != 1 for ts in zip(*leaves)
        ):
            raise ValueError("params, grads and the moments must be trees of one structure")
        flat_p, flat_g, flat_m, flat_v = leaves
        gnorm = global_norm(flat_g) if grad_norm is None else grad_norm
        if cfg.grad_clip > 0:  # clip_by_global_norm, in place where the dtype allows
            scale = _clip_scale(gnorm, cfg.grad_clip)
            flat_g = [_scaled(g, scale) for g in flat_g]
        b1, b2 = cfg.b1, cfg.b2
        stepf = step.to(torch.float32)
        bc1 = 1 - torch.pow(_f32(b1).to(stepf.device), stepf)
        bc2 = 1 - torch.pow(_f32(b2).to(stepf.device), stepf)
        for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
            decay = cfg.weight_decay > 0 and p.dim() >= 2  # decay matrices only
            # in pieces of rows: elementwise, so the same numbers, with a
            # piece's temporaries rather than a leaf's
            for pp, gg, mm, vv in zip(*(_pieces(t) for t in (p, g, m, v))):
                _update_leaf(cfg, pp, gg, mm, vv, lr, bc1, bc2, decay)
        metrics = {"lr": lr, "grad_norm": gnorm, "step": step.clone()}
        return params, state, metrics


PIECE_ELEMENTS = 1 << 25  # 128 MiB of fp32: the most the update touches at once


def _rows_a_piece(p: torch.Tensor) -> int:
    return max(1, PIECE_ELEMENTS // max(1, p[0].numel()))


def _pieces(t: torch.Tensor):
    """Views of ``t`` over runs of its leading dimension, each at most
    ``PIECE_ELEMENTS`` (or one row, if a row is larger)."""
    if t.dim() == 0:
        return (t,)
    return t.split(_rows_a_piece(t), 0)


def _scaled(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(g.float() * scale).to(g.dtype)``, in place when g is fp32."""
    if g.dtype == torch.float32:
        return g.mul_(scale)
    return (g.float() * scale).to(g.dtype)


def _update_leaf(cfg: AdamWConfig, p, g, m, v, lr, bc1, bc2, decay: bool) -> None:
    """m, v and p in place, in fp32 arithmetic, stored in their dtypes:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g²``, ``p -= lr
    (m / bc1 / (sqrt(v / bc2) + eps) + wd p)``."""
    g32 = g.float()
    m32, v32 = m.float(), v.float()  # the moments themselves when fp32
    m32.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
    v32.mul_(cfg.b2).add_(g32.square(), alpha=1 - cfg.b2)
    if m32.data_ptr() != m.data_ptr():
        m.copy_(m32)
        v.copy_(v32)
    delta = (m32 / bc1).div_(torch.sqrt(v32 / bc2).add_(cfg.eps))
    if decay:
        delta.add_(p.float(), alpha=cfg.weight_decay)
    delta.mul_(lr)
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)
