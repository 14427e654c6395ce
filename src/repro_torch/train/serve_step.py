"""Serve-step factories: prefill and decode, a token sampler, and a greedy
generation loop (the JAX package's ``train/serve_step.py``).

``decode`` is one new token a sequence against a KV cache (or recurrent
state). PyTorch runs eagerly, so the steps are the model's methods; the
loop keeps the tokens on the params' device and reads nothing back to the
host between steps. ``sample_token`` at a temperature above 0 draws from
an explicit ``torch.Generator``: it does not reproduce ``jax.random``.

On a mesh (JAX's dryrun lowers these steps so) they run under the active
sharding context, or the params' mesh's own if none is, with params
placed by ``param_shardings(serve=True)``, the batch by
``batch_shardings`` and the cache by ``cache_shardings`` (``DTensor``s):
each rank computes on its pieces, the model splitting its work on the
model axis (``models/model.py``). The prefill step returns
the cache so placed and the decode step takes it so; the logits are this
rank's rows over the whole vocabulary. ``greedy_generate`` takes placed
params and keeps the cache as the rank's plain pieces.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor
from torch.utils import _pytree as pytree

from repro_torch.configs.base import ShapeConfig
from repro_torch.dist.sharding import cache_shardings
from repro_torch.models.model import Model
from repro_torch.train.train_step import is_sharded, local_pieces, on_mesh


def make_prefill_step(model: Model, max_len: Optional[int] = None):
    def prefill_step(params, batch):
        if not is_sharded(params):
            return model.prefill(params, batch, max_len=max_len)
        with on_mesh(params, model):
            logits, cache = model.prefill(local_pieces(params), local_pieces(batch),
                                          max_len=max_len)
        b, s = batch["frame_embeds" if "frame_embeds" in batch else "tokens"].shape[:2]
        whole = model.init_cache(b, max_len or s, device="meta")
        lays = cache_shardings({name: whole[name] for name in cache}, model.cfg,
                               ShapeConfig("prefill", "prefill", s, b),
                               pytree.tree_leaves(params)[0].device_mesh)
        return logits, pytree.tree_map(
            lambda t, lay: DTensor.from_local(t, *lay, run_check=False), cache, lays)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, batch, cache, pos):
        if not is_sharded(params):
            return model.decode(params, batch, cache, pos)
        with on_mesh(params, model):
            logits, new = model.decode(local_pieces(params), local_pieces(batch),
                                       local_pieces(cache), pos)
        return logits, pytree.tree_map(
            lambda t, c: DTensor.from_local(t, c.device_mesh, c.placements, run_check=False),
            new, cache)

    return decode_step


def sample_token(
    logits: torch.Tensor,  # (..., vocab)
    generator: Optional[torch.Generator],
    temperature: float = 1.0,
) -> torch.Tensor:
    """int32 tokens of shape ``logits.shape[:-1]``: the argmax at
    temperature 0, else a draw from ``softmax(logits / temperature)``
    (fp32) by ``generator``, which must then be given."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    if generator is None:
        raise ValueError("sampling at a temperature above 0 needs a torch.Generator")
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1, generator=generator)
    return flat.reshape(logits.shape[:-1]).to(torch.int32)


def greedy_generate(
    model: Model,
    params,
    prompt: Dict[str, torch.Tensor],
    n_tokens: int,
    max_len: int,
) -> torch.Tensor:
    """Prefill ``prompt`` (its ``tokens`` (b, s), or ``frame_embeds`` for
    audio) into a cache of ``max_len``, then decode greedily, feeding
    back tokens: ``n_tokens`` tokens (b, n_tokens) int32, the first from
    the prefill's logits, on the params' device. On a mesh ``prompt`` is
    the rank's rows, and so are the tokens."""
    dev = params["final_norm"]["scale"].device
    prompt = {name: t.to(dev) for name, t in prompt.items()}
    pos = (prompt["tokens"] if "tokens" in prompt else prompt["frame_embeds"]).shape[1]
    with on_mesh(params, model):
        params = local_pieces(params)
        logits, cache = model.prefill(params, prompt, max_len=max_len)
        out = [sample_token(logits, None, 0.0)[:, None]]
        for i in range(n_tokens - 1):
            logits, cache = model.decode(params, {"tokens": out[-1]}, cache, pos + i)
            out.append(sample_token(logits[:, -1], None, 0.0)[:, None])
    return torch.cat(out, dim=1)
