"""Architecture and shape configuration (copies of the JAX package's
``ArchConfig`` and ``ShapeConfig``).

Every architecture is an :class:`ArchConfig`; the reduced smoke variants
used by CPU tests are derived with :meth:`ArchConfig.smoke` so they stay
structurally faithful to the full config. A :class:`ShapeConfig` is one
workload shape (train / prefill / decode) with its sequence length and
global batch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens_per_step(self) -> int:
        if self.kind == "decode":
            return self.global_batch  # one new token per sequence
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


@dataclass(frozen=True)
class ArchConfig:
    """A transformer-family architecture, parameterized enough to cover the
    dense / MoE / SSM / hybrid / audio / VLM members of the pool."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int  # 0 => attention-free (rwkv)
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0

    # --- SSM / hybrid (hymba, rwkv) ---
    ssm_state: int = 0  # mamba state size per channel
    ssm_conv: int = 4  # depthwise conv width for mamba branch
    ssm_expand: int = 2  # mamba inner expansion
    rwkv_head_dim: int = 0  # rwkv6 head size (d_model/rwkv_head_dim heads)

    # --- attention details ---
    sliding_window: int = 0  # 0 = full (quadratic) attention
    qk_norm: bool = False
    qkv_bias: bool = False

    # --- MLP ---
    gated_act: str = "silu"  # silu (SwiGLU) | gelu (GeGLU)

    # --- embeddings / positions ---
    rope_variant: str = "rope"  # rope | mrope | none
    rope_theta: float = 1_000_000.0
    tie_embeddings: bool = False
    scale_embeddings: bool = False  # gemma multiplies embeds by sqrt(d)

    # --- modality frontend stub ---
    frontend: str = "none"  # none | audio_frames | vision_patches
    n_frontend_tokens: int = 0  # patches/frames provided via input_specs

    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    # Derived properties
    # ------------------------------------------------------------------

    @property
    def attention_free(self) -> bool:
        return self.n_kv_heads == 0 and self.family == "ssm"

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def sub_quadratic(self) -> bool:
        """True when the arch can serve 500k-token contexts: SSM state,
        sliding-window attention, or hybrid of the two."""
        return self.family == "ssm" or self.sliding_window > 0

    def supports(self, shape: ShapeConfig) -> bool:
        return self.sub_quadratic if shape.name == "long_500k" else True

    # ------------------------------------------------------------------
    # Parameter counting (analytic)
    # ------------------------------------------------------------------

    def _attn_params(self) -> int:
        if self.attention_free:
            # rwkv6 time-mix: r,k,v,g,o projections + decay/lerp loras
            h = self.d_model
            lora = 5 * (h * 32 + 32 * h) + (h * 64 + 64 * h)  # ddlerp + decay
            return 5 * h * h + lora + 2 * h  # r,k,v,g,out + ln params
        p = self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim
        p += self.q_dim * self.d_model  # out proj
        if self.qkv_bias:
            p += self.q_dim + 2 * self.kv_dim
        if self.qk_norm:
            p += 2 * self.head_dim
        return p

    def _mlp_params(self) -> int:
        if self.is_moe:
            per_expert = 3 * self.d_model * self.d_ff
            router = self.d_model * self.n_experts
            return self.n_experts * per_expert + router
        if self.family == "ssm":  # rwkv channel mix
            return 2 * self.d_model * self.d_ff + self.d_model * self.d_model
        return 3 * self.d_model * self.d_ff  # swiglu/geglu: gate,up,down

    def _ssm_params(self) -> int:
        if self.family not in ("hybrid",):
            return 0
        d_inner = self.ssm_expand * self.d_model
        p = self.d_model * d_inner * 2  # in_proj (x, z)
        p += d_inner * self.ssm_conv  # depthwise conv
        p += d_inner * (2 * self.ssm_state + 1)  # B,C,dt projections (fused approx)
        p += d_inner * self.d_model  # out proj
        p += d_inner  # A_log + D
        return p

    def param_count(self) -> int:
        per_layer = self._attn_params() + self._mlp_params() + self._ssm_params()
        per_layer += 2 * self.d_model  # norms
        total = self.n_layers * per_layer
        total += self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        total += self.d_model  # final norm
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts active)."""
        inactive = (self.n_experts - self.top_k) * 3 * self.d_model * self.d_ff
        return self.param_count() - (self.n_layers * inactive if self.is_moe else 0)

    # ------------------------------------------------------------------
    # Smoke (reduced) variant for CPU tests
    # ------------------------------------------------------------------

    def smoke(self) -> "ArchConfig":
        """Structurally faithful tiny variant: same family/features, small
        dims. Keeps divisibility invariants (heads, experts)."""
        n_heads = max(2, min(4, self.n_heads))
        n_kv = 0 if self.n_kv_heads == 0 else max(1, min(2, self.n_kv_heads))
        if n_kv:
            n_heads = (n_heads // n_kv) * n_kv or n_kv
        return replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            d_model=64,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=4 if self.is_moe else 0,
            top_k=min(2, self.top_k) if self.is_moe else 0,
            ssm_state=8 if self.ssm_state else 0,
            rwkv_head_dim=16 if self.rwkv_head_dim else 0,
            sliding_window=32 if self.sliding_window else 0,
            n_frontend_tokens=4 if self.n_frontend_tokens else 0,
            rope_theta=10_000.0,
        )


def batch_spec(arch: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Describe the *host-level* input batch for one step as
    {name: (shape_tuple, dtype_str)} (the JAX package's ``batch_spec``).
    ``dist.sharding.batch_shardings`` lays these out on a mesh; the data
    pipeline materializes real arrays of the same spec."""
    b, s = shape.global_batch, shape.seq_len
    specs: Dict[str, Any] = {}
    if shape.kind == "train":
        if arch.frontend == "audio_frames":
            # EnCodec frame embeddings are precomputed by the (stub) frontend.
            specs["frame_embeds"] = ((b, s, arch.d_model), "bfloat16")
            specs["labels"] = ((b, s), "int32")
        else:
            specs["tokens"] = ((b, s), "int32")
            specs["labels"] = ((b, s), "int32")
        if arch.frontend == "vision_patches":
            specs["patch_embeds"] = ((b, arch.n_frontend_tokens, arch.d_model), "bfloat16")
        if arch.rope_variant == "mrope":
            specs["positions"] = ((b, 3, s), "int32")
    elif shape.kind == "prefill":
        if arch.frontend == "audio_frames":
            specs["frame_embeds"] = ((b, s, arch.d_model), "bfloat16")
        else:
            specs["tokens"] = ((b, s), "int32")
        if arch.frontend == "vision_patches":
            specs["patch_embeds"] = ((b, arch.n_frontend_tokens, arch.d_model), "bfloat16")
        if arch.rope_variant == "mrope":
            specs["positions"] = ((b, 3, s), "int32")
    elif shape.kind == "decode":
        if arch.frontend == "audio_frames":
            specs["frame_embeds"] = ((b, 1, arch.d_model), "bfloat16")
        else:
            specs["tokens"] = ((b, 1), "int32")
        if arch.rope_variant == "mrope":
            specs["positions"] = ((b, 3, 1), "int32")
    else:
        raise ValueError(f"unknown shape kind {shape.kind}")
    return specs
