"""Serve-step factories: prefill and decode, a token sampler, and a greedy
generation loop (the JAX package's ``train/serve_step.py``).

``decode`` is one new token a sequence against a KV cache (or recurrent
state). PyTorch runs eagerly, so the steps are the model's methods; the
loop keeps the tokens on the params' device and reads nothing back to the
host between steps. ``sample_token`` at a temperature above 0 draws from
an explicit ``torch.Generator``: it does not reproduce ``jax.random``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.model import Model


def make_prefill_step(model: Model, max_len: Optional[int] = None):
    def prefill_step(params, batch):
        return model.prefill(params, batch, max_len=max_len)

    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, batch, cache, pos):
        return model.decode(params, batch, cache, pos)

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
    the prefill's logits, on the params' device."""
    dev = params["final_norm"]["scale"].device
    prompt = {name: t.to(dev) for name, t in prompt.items()}
    logits, cache = model.prefill(params, prompt, max_len=max_len)
    pos = (prompt["tokens"] if "tokens" in prompt else prompt["frame_embeds"]).shape[1]
    out = [sample_token(logits, None, 0.0)[:, None]]
    for i in range(n_tokens - 1):
        logits, cache = model.decode(params, {"tokens": out[-1]}, cache, pos + i)
        out.append(sample_token(logits[:, -1], None, 0.0)[:, None])
    return torch.cat(out, dim=1)
