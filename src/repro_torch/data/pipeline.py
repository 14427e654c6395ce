"""Deterministic synthetic data pipeline (a copy of the JAX package's
``data/pipeline.py``, which is numpy only: the same seed and step give the
same arrays byte for byte).

Tokens come from a learnable-order Markov chain (next ~ affine function of
current + noise), so small models measurably reduce loss within a few
hundred steps — the end-to-end example needs visible learning, not random
labels. Every batch is a pure function of (seed, step): restart-safe, and
each host can slice its own shard (``host_slice``) without coordination.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig, ShapeConfig


@dataclass
class SyntheticLM:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05  # fraction of tokens replaced with uniform noise

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=self.seed, counter=step))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng(step)
        b, s, v = self.global_batch, self.seq_len + 1, self.vocab_size
        x = np.empty((b, s), np.int64)
        x[:, 0] = rng.integers(0, v, size=b)
        # affine chain with per-sequence multiplier; mostly predictable
        a = rng.integers(1, 7, size=(b, 1))
        for t in range(1, s):
            x[:, t] = (a[:, 0] * x[:, t - 1] + 1) % v
        noise_mask = rng.random((b, s)) < self.noise
        x = np.where(noise_mask, rng.integers(0, v, size=(b, s)), x)
        return {
            "tokens": x[:, :-1].astype(np.int32),
            "labels": x[:, 1:].astype(np.int32),
        }

    def host_slice(self, step: int, host_id: int, n_hosts: int) -> Dict[str, np.ndarray]:
        full = self.batch(step)
        per = self.global_batch // n_hosts
        return {
            k: v[host_id * per : (host_id + 1) * per] for k, v in full.items()
        }


def make_batch_for(
    arch: ArchConfig, shape: ShapeConfig, step: int = 0, seed: int = 0
) -> Dict[str, np.ndarray]:
    """Materialize a real batch matching ``configs.base.batch_spec``."""
    rng = np.random.Generator(np.random.Philox(key=seed, counter=step))
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, np.ndarray] = {}
    if shape.kind == "train":
        pipe = SyntheticLM(arch.vocab_size, s, b, seed=seed)
        lm = pipe.batch(step)
        if arch.frontend == "audio_frames":
            out["frame_embeds"] = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
            out["labels"] = lm["labels"]
        else:
            out.update(lm)
    elif shape.kind == "prefill":
        if arch.frontend == "audio_frames":
            out["frame_embeds"] = rng.standard_normal((b, s, arch.d_model)).astype(np.float32)
        else:
            out["tokens"] = rng.integers(0, arch.vocab_size, size=(b, s)).astype(np.int32)
    else:  # decode
        if arch.frontend == "audio_frames":
            out["frame_embeds"] = rng.standard_normal((b, 1, arch.d_model)).astype(np.float32)
        else:
            out["tokens"] = rng.integers(0, arch.vocab_size, size=(b, 1)).astype(np.int32)
    if arch.frontend == "vision_patches" and shape.kind != "decode":
        out["patch_embeds"] = rng.standard_normal(
            (b, arch.n_frontend_tokens, arch.d_model)
        ).astype(np.float32)
    if arch.rope_variant == "mrope":
        n = 1 if shape.kind == "decode" else s
        pos = np.broadcast_to(np.arange(n, dtype=np.int32), (b, n))
        out["positions"] = np.stack([pos, pos, pos], axis=1)
    return out
