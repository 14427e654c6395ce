"""Model: ``build_model(cfg)`` -> a :class:`Model` with init / apply /
prefill for the dense decoder family (the JAX package's
``models/model.py``, forward only: training, decode and the other
families come in later slices).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention, transformer
from repro_torch.models.layers import (
    Params,
    check_kernel_mode,
    embed_init,
    positions_from_tokens,
    rmsnorm,
    rmsnorm_init,
)


@dataclass
class ModelOptions:
    # "kernel": CUDA tensors go through the hand-written kernels and CPU
    # tensors through their plain versions; "reference": plain everywhere
    kernel_mode: str = "kernel"
    compute_dtype: str = "bfloat16"
    param_dtype: str = "float32"


class Model:
    def __init__(self, cfg: ArchConfig, opts: Optional[ModelOptions] = None):
        if cfg.family != "dense" or cfg.frontend != "none":
            raise NotImplementedError(
                f"{cfg.name}: only the dense text family is ported so far"
            )
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        check_kernel_mode(self.opts.kernel_mode)

    # ------------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        """Random params on ``generator.device``, drawn from ``generator``."""
        cfg = self.cfg
        dtype = getattr(torch, self.opts.param_dtype)
        params: Params = {
            "embed": {"table": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)},
            "layers": transformer.layer_init(generator, cfg, dtype),
            "final_norm": rmsnorm_init(cfg.d_model, dtype, generator.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = {
                "table": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)
            }
        return params

    def _compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.opts.compute_dtype)

    def _embed(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cdt = self._compute_dtype()
        x = params["embed"]["table"][batch["tokens"]].to(cdt)
        if self.cfg.scale_embeddings:
            x = x * torch.tensor(self.cfg.d_model ** 0.5, dtype=cdt, device=x.device)
        return x

    def _head_table(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["table"]
        return params["lm_head"]["table"]

    def _trunk(self, params: Params, batch: Dict, on_kv=None) -> torch.Tensor:
        x = self._embed(params, batch)
        b, s = x.shape[0], x.shape[1]
        positions = positions_from_tokens(b, s, device=x.device)
        return transformer.stack_apply(
            params["layers"], self.cfg, x, positions,
            compute_dtype=self._compute_dtype(), kernel_mode=self.opts.kernel_mode,
            on_kv=on_kv,
        )

    def apply(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full logits (small models / tests only) and the aux loss, which
        is 0 for the dense family."""
        x = self._trunk(params, batch)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps, kernel_mode=self.opts.kernel_mode)
        table = self._head_table(params).to(self._compute_dtype())
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x @ table.T, aux

    # ------------------------------------------------------------------
    # Serving: prefill
    # ------------------------------------------------------------------

    def prefill(
        self, params: Params, batch: Dict, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Dict]:
        """Run the full prompt once; return (last-token logits, KV cache).

        The cache holds each layer's rotated K/V as ``(n_layers, b, cap,
        hkv, head_dim)`` in the compute dtype, ``cap =
        cache_capacity(cfg, max_len)``: the last ``cap`` tokens, zero-padded
        at the end when the prompt is shorter (room for decode steps).
        ``max_len`` defaults to the prompt length."""
        x, cache = self._prefill_trunk(params, batch, max_len=max_len)
        # the norm is row-wise: normalizing only the last position gives
        # the last row of the full normalized sequence (copied, because the
        # RMSNorm kernel takes contiguous rows)
        x = rmsnorm(
            params["final_norm"], x[:, -1].contiguous(), self.cfg.norm_eps,
            kernel_mode=self.opts.kernel_mode,
        )
        table = self._head_table(params).to(self._compute_dtype())
        return x @ table.T, cache

    def _prefill_trunk(self, params: Params, batch: Dict, max_len: Optional[int] = None):
        cfg = self.cfg
        tokens = batch["tokens"]
        b, s = tokens.shape
        cap = attention.cache_capacity(cfg, max_len if max_len is not None else s)
        shape = (cfg.n_layers, b, cap, cfg.n_kv_heads, cfg.head_dim)
        cdt = self._compute_dtype()
        cache = {
            "k": torch.zeros(shape, dtype=cdt, device=tokens.device),
            "v": torch.zeros(shape, dtype=cdt, device=tokens.device),
        }

        def keep(i: int, k: torch.Tensor, v: torch.Tensor) -> None:
            # the last `cap` tokens; a ring cache (sliding window) aligns
            # token p to slot p % cap; shorter prompts pad at the end
            n = min(s, cap)
            k, v = k[:, -n:], v[:, -n:]
            if cfg.sliding_window > 0 and s >= cap and s % cap:
                k = torch.roll(k, s % cap, dims=1)
                v = torch.roll(v, s % cap, dims=1)
            cache["k"][i, :, :n] = k
            cache["v"][i, :, :n] = v

        return self._trunk(params, batch, on_kv=keep), cache


def build_model(cfg: ArchConfig, opts: Optional[ModelOptions] = None) -> Model:
    return Model(cfg, opts)
