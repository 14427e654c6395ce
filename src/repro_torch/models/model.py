"""Model: ``build_model(cfg)`` -> a :class:`Model` with init / apply /
loss / prefill / init_cache / decode for every family of the JAX
package's ``models/model.py``: dense, MoE, rwkv (``ssm``), hybrid
(hymba), vlm and audio. ``loss`` is the causal LM loss with a
seq-chunked head that never materializes the full logits, plus
``aux_coeff`` times the MoE layers' mean load-balance loss.

The modality frontends are stubs, as in the JAX package: an
``audio_frames`` model has no embedding table and takes
``batch["frame_embeds"]`` (b, s, d_model) in place of tokens; a
``vision_patches`` model splices ``batch["patch_embeds"]`` (b, n, d_model)
over its first n token embeddings, and under M-RoPE every call takes
``batch["positions"]`` (b, 3, s), decode's (b, 3, 1).

Serving: ``prefill`` runs a prompt and emits the decode cache (int8 K/V
with fp16 scales under ``kv_quantized``, as the JAX package's prefill
does); ``decode`` runs one token for every sequence against it, ``pos``
(a host int) being the tokens already cached. ``unstack_cache`` turns a
stacked cache into per-layer dicts.

On a model axis (``dist.api``; the params are the rank's pieces) the
vocabulary is split where the guard lets it (``embed/table`` and
``lm_head/table`` rows): the embedding looks up the rank's rows, zeros
elsewhere, and all-reduces; the loss takes each chunk's local logits, the
global max and sum of exponentials by all-reduce, and the gold logit from
the rank that holds it, so the full logits are never gathered for it;
``apply``, ``prefill`` and ``decode`` all-gather their logits once. The
blocks split their own work (``transformer``), and the cache prefill
returns holds the rank's pieces of each leaf, as its first layer's
entries shape them.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.dist.api import WHOLE, ModelAxis, split_at
from repro_torch.models import attention, rwkv, ssm, transformer
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
    wkv_chunk: int = 64  # rwkv: time steps per WKV chunk
    remat: bool = True  # checkpoint each layer when a gradient is taken
    loss_chunk: int = 512  # sequence positions a chunk of the loss head
    # the plain attention's query chunk (memory only: the same result)
    attn_q_chunk: int = 4096
    moe_group: int = 4096  # MoE: tokens a routing group (moe.moe_apply)
    ssm_chunk: int = 128  # hybrid: time steps a chunk of the SSM scan
    decode_cache_mode: str = "carry"  # carry | stream (transformer.stack_decode)
    kv_quantized: bool = False  # int8 KV cache with fp16 scales (serving)
    aux_coeff: float = 0.01


class Model:
    def __init__(self, cfg: ArchConfig, opts: Optional[ModelOptions] = None):
        self.cfg = cfg
        self.opts = opts or ModelOptions()
        check_kernel_mode(self.opts.kernel_mode)
        if self.opts.decode_cache_mode not in transformer.CACHE_MODES:
            raise ValueError(f"decode_cache_mode must be one of {transformer.CACHE_MODES}, "
                             f"got {self.opts.decode_cache_mode!r}")

    # ------------------------------------------------------------------

    def init(self, generator: torch.Generator) -> Params:
        """Random params on ``generator.device``, drawn from ``generator``."""
        cfg = self.cfg
        dtype = getattr(torch, self.opts.param_dtype)
        params: Params = {}
        if cfg.frontend != "audio_frames":  # audio frames stand in for the table
            params["embed"] = {"table": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)}
        params["layers"] = transformer.layer_init(generator, cfg, dtype)
        params["final_norm"] = rmsnorm_init(cfg.d_model, dtype, generator.device)
        if not cfg.tie_embeddings:
            params["lm_head"] = {
                "table": embed_init(generator, cfg.vocab_size, cfg.d_model, dtype)
            }
        return params

    def _compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.opts.compute_dtype)

    def _embed(self, params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        cfg, cdt = self.cfg, self._compute_dtype()
        if cfg.frontend == "audio_frames":
            x = batch["frame_embeds"].to(cdt)
        else:
            table, tokens = params["embed"]["table"], batch["tokens"]
            ax = self._vocab_axis()
            if ax.size == 1:
                x = table[tokens].to(cdt)
            else:  # the rank's rows, zeros for the others' tokens, summed
                ids = tokens - ax.rank * table.shape[0]
                mine = (ids >= 0) & (ids < table.shape[0])
                x = ax.reduce(table[ids.clamp(0, table.shape[0] - 1)] * mine[..., None]).to(cdt)
            if cfg.scale_embeddings:
                x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cdt, device=x.device)
        if cfg.frontend == "vision_patches" and "patch_embeds" in batch:
            n = batch["patch_embeds"].shape[1]
            if x.shape[1] >= n:  # the patch embeddings over the first n slots
                x = torch.cat([batch["patch_embeds"].to(cdt), x[:, n:]], dim=1)
        return x

    def _head_table(self, params: Params) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"]["table"]
        return params["lm_head"]["table"]

    def _vocab_axis(self) -> ModelAxis:
        """The model axis where it splits the vocabulary, else ``WHOLE``."""
        return split_at(("model", None), (self.cfg.vocab_size, self.cfg.d_model))

    def _logits(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``x @ tableᵀ`` in the compute dtype, the whole vocabulary."""
        table = self._head_table(params).to(self._compute_dtype())
        ax = self._vocab_axis()
        return ax.gather(ax.copy(x) @ table.T)

    def _positions(self, batch: Dict, x: torch.Tensor) -> Optional[torch.Tensor]:
        """The rotary positions of ``x`` (b, s, d): the batch's (b, 3, s) ids
        under M-RoPE, ``0 .. s - 1`` under RoPE, none without rotation."""
        if self.cfg.rope_variant == "mrope":
            return batch["positions"]
        if self.cfg.rope_variant == "none":
            return None
        return positions_from_tokens(x.shape[0], x.shape[1], device=x.device)

    def _trunk(
        self, params: Params, batch: Dict,
        on_cache: Optional[transformer.CacheSink] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the layers' output, the mean aux loss)."""
        x = self._embed(params, batch)
        o = self.opts
        return transformer.stack_apply(
            params["layers"], self.cfg, x, self._positions(batch, x),
            compute_dtype=self._compute_dtype(), kernel_mode=o.kernel_mode,
            wkv_chunk=o.wkv_chunk, attn_q_chunk=o.attn_q_chunk, moe_group=o.moe_group,
            ssm_chunk=o.ssm_chunk, on_cache=on_cache, remat=o.remat,
        )

    def apply(self, params: Params, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full logits (small models / tests only) and the aux loss: the
        mean of the layers' load-balance losses, 0 for the dense and rwkv
        families."""
        x, aux = self._trunk(params, batch)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps, kernel_mode=self.opts.kernel_mode)
        return self._logits(params, x), aux

    def loss(self, params: Params, batch: Dict) -> torch.Tensor:
        """Causal LM loss, fp32: the mean over ``(b, s)`` of ``logsumexp -
        gold logit``, plus ``aux_coeff`` times the aux loss. The
        head runs over sequence chunks of ``min(loss_chunk, s)`` positions
        (``s`` when that does not divide it); each chunk's logits are the
        compute-dtype product cast to fp32, and under a gradient each chunk
        is checkpointed, so no more than one chunk's logits are live."""
        x, aux = self._trunk(params, batch)
        x = rmsnorm(params["final_norm"], x, self.cfg.norm_eps, kernel_mode=self.opts.kernel_mode)
        labels = batch["labels"]
        table = self._head_table(params).to(self._compute_dtype())
        b, s, _ = x.shape
        chunk = min(self.opts.loss_chunk, s)
        if s % chunk:
            chunk = s
        grad = torch.is_grad_enabled() and (x.requires_grad or table.requires_grad)
        ax = self._vocab_axis()
        x = ax.copy(x)
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, chunk):
            xc, lc = x[:, i : i + chunk], labels[:, i : i + chunk]
            if grad:
                total = total + checkpoint(
                    _chunk_nll, xc, lc, table, ax, use_reentrant=False, preserve_rng_state=False
                )
            else:
                total = total + _chunk_nll(xc, lc, table, ax)
        return total / (b * s) + self.opts.aux_coeff * aux

    # ------------------------------------------------------------------
    # Serving: prefill + decode
    # ------------------------------------------------------------------

    def init_cache(
        self, batch: int, max_len: int, stacked: bool = True, *, device: torch.device
    ) -> transformer.Cache:
        """Empty decode state on ``device``. ``stacked``: leaves with a
        leading ``n_layers`` axis; otherwise a tuple of per-layer dicts
        (views of one stacked allocation)."""
        cfg = self.cfg
        cdt = self._compute_dtype()
        if cfg.family == "ssm":
            cache = rwkv.rwkv_init_state(cfg, batch, cdt, device)
        else:
            cap = attention.cache_capacity(cfg, max_len)
            cache = attention.init_kv_cache(
                cfg, batch, cap, cdt, quantized=self.opts.kv_quantized, device=device
            )
            if cfg.family == "hybrid":
                cache.update(ssm.ssm_init_state(cfg, batch, cdt, device))
        return cache if stacked else unstack_cache(cache, cfg.n_layers)

    def prefill(
        self, params: Params, batch: Dict, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Dict]:
        """Run the full prompt once; return (last-token logits, cache).

        Dense: the cache holds each layer's rotated K/V as ``(n_layers, b,
        cap, hkv, head_dim)`` in the compute dtype (int8 with fp16 scales
        ``(n_layers, b, cap, hkv)`` under ``kv_quantized``), ``cap =
        cache_capacity(cfg, max_len)``: the last ``cap`` tokens, zero-padded
        at the end when the prompt is shorter (room for decode steps).
        ``max_len`` defaults to the prompt length.

        Hybrid: also the SSM state of ``ssm.ssm_init_state``, ``h``
        ``(n_layers, b, d_inner, n)`` fp32 and ``conv`` ``(n_layers, b,
        ssm_conv - 1, d_inner)`` (fewer slots when the prompt is shorter,
        as in the JAX package) in the compute dtype.

        rwkv: the recurrent state of ``rwkv.rwkv_init_state``, the
        token-shift carries ``tmix_shift``/``cmix_shift`` ``(n_layers, b, 1,
        d)`` in the compute dtype and ``wkv`` ``(n_layers, b, h, dk, dv)``
        fp32; ``max_len`` does not size it."""
        x, cache = self._prefill_trunk(params, batch, max_len=max_len)
        # the norm is row-wise: normalizing only the last position gives
        # the last row of the full normalized sequence (copied, because the
        # RMSNorm kernel takes contiguous rows)
        x = rmsnorm(
            params["final_norm"], x[:, -1].contiguous(), self.cfg.norm_eps,
            kernel_mode=self.opts.kernel_mode,
        )
        return self._logits(params, x), cache

    def _prefill_trunk(self, params: Params, batch: Dict, max_len: Optional[int] = None):
        cfg = self.cfg
        inputs = batch["frame_embeds"] if cfg.frontend == "audio_frames" else batch["tokens"]
        s = inputs.shape[1]
        cache: Dict[str, torch.Tensor] = {}

        def put(i: int, name: str, t: torch.Tensor, slots: int = 0) -> None:
            """Layer ``i``'s entry into the stacked leaf ``name``: zeros made
            at the first layer in ``t``'s shape and dtype (the rank's pieces
            on a model axis), dim 1 ``slots`` long if given (a KV cache's
            capacity), ``t`` written into its first rows."""
            if name not in cache:
                shape = (t.shape[0], slots, *t.shape[2:]) if slots else t.shape
                cache[name] = t.new_zeros((cfg.n_layers, *shape))
            cache[name][i, :, : t.shape[1]] = t

        if cfg.family == "ssm":

            def keep(i: int, entries: transformer.CacheEntries) -> None:
                for name, t in entries.items():
                    put(i, name, t)

            return self._trunk(params, batch, on_cache=keep)[0], cache

        cap = attention.cache_capacity(cfg, max_len if max_len is not None else s)

        def keep_kv(i: int, entries: transformer.CacheEntries) -> None:
            # the last `cap` tokens; a ring cache (sliding window) aligns
            # token p to slot p % cap; shorter prompts pad at the end
            n = min(s, cap)
            k, v = entries["k"][:, -n:], entries["v"][:, -n:]
            if cfg.sliding_window > 0 and s >= cap and s % cap:
                k = torch.roll(k, s % cap, dims=1)
                v = torch.roll(v, s % cap, dims=1)
            scales = {}
            if self.opts.kv_quantized:  # int8 end to end: decode reads and extends it
                k, scales["k_scale"] = attention.quantize_kv(k)
                v, scales["v_scale"] = attention.quantize_kv(v)
            for name, t in {"k": k, "v": v, **scales}.items():
                put(i, name, t, cap)
            if cfg.family == "hybrid":
                put(i, "h", entries["h"])
                put(i, "conv", entries["conv"])

        return self._trunk(params, batch, on_cache=keep_kv)[0], cache

    def decode(
        self, params: Params, batch: Dict, cache: transformer.Cache, pos: Union[int, torch.Tensor]
    ) -> Tuple[torch.Tensor, transformer.Cache]:
        """One token ``batch["tokens"]`` (b, 1) (``frame_embeds`` (b, 1,
        d_model) for audio; M-RoPE also takes ``positions`` (b, 3, 1)) for
        every sequence against ``cache``; ``pos`` is the count of tokens
        already cached (a host int: a tensor is read back to the host).
        Returns ``(logits (b, 1, vocab) in the compute dtype, new cache)``;
        the cache keeps its form (stacked or per layer), and
        ``decode_cache_mode`` says whether it is updated in place
        (``"carry"``) or left as it is (``"stream"``)."""
        cfg, o = self.cfg, self.opts
        pos = int(pos)
        x = self._embed(params, batch)
        positions = None
        if cfg.rope_variant == "mrope":
            positions = batch["positions"]
        elif cfg.rope_variant != "none":
            positions = torch.full((x.shape[0], 1), pos, dtype=torch.int32, device=x.device)
        x, new_cache = transformer.stack_decode(
            params["layers"], cfg, x, positions, cache, pos,
            compute_dtype=self._compute_dtype(), kernel_mode=o.kernel_mode,
            cache_mode=o.decode_cache_mode,
        )
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps, kernel_mode=o.kernel_mode)
        return self._logits(params, x), new_cache


def _chunk_nll(
    x: torch.Tensor, labels: torch.Tensor, table: torch.Tensor, ax: ModelAxis = WHOLE
) -> torch.Tensor:
    """Summed negative log-likelihood of one chunk: ``(b, c, d) @ tableᵀ``
    in the compute dtype, then fp32. ``ax``: the model axis splitting the
    vocabulary, ``table`` the rank's rows."""
    logits = (x @ table.T).float()
    if ax.size == 1:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        return (logz - gold).sum()
    n = table.shape[0]
    top = ax.gather(logits.detach().amax(dim=-1, keepdim=True)).amax(dim=-1)
    logz = torch.log(ax.reduce(torch.exp(logits - top[..., None]).sum(dim=-1))) + top
    ids = labels.long() - ax.rank * n
    mine = (ids >= 0) & (ids < n)
    gold = torch.gather(logits, -1, ids.clamp(0, n - 1)[..., None])[..., 0]
    return (logz - ax.reduce(gold * mine)).sum()


def unstack_cache(cache: Dict[str, torch.Tensor], n_layers: int) -> Tuple[Dict, ...]:
    """(L, ...)-stacked cache -> tuple of per-layer dicts (views)."""
    return tuple({n: t[i] for n, t in cache.items()} for i in range(n_layers))


def build_model(cfg: ArchConfig, opts: Optional[ModelOptions] = None) -> Model:
    return Model(cfg, opts)
