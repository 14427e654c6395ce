"""Per-(arch x shape) runtime knobs: microbatching, dtypes, chunk sizes
(the JAX package's ``train/runtime.py``, its table as it is, mapped onto
the port's ``ModelOptions``: the port has no layer scan, and its
``kernel_mode`` defaults to ``"kernel"``, the hand-written
CUDA kernels). Serving shapes (decode and prefill) hold bf16 params and
an int8 KV cache, as in the JAX package."""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.model import ModelOptions
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import TrainRunConfig

# arch -> (train microbatches, param_dtype, accum_dtype)
_TRAIN_TABLE = {
    "hymba-1.5b": (4, "float32", "float32"),
    "qwen3-moe-235b-a22b": (16, "bfloat16", "bfloat16"),
    "mixtral-8x22b": (16, "bfloat16", "bfloat16"),
    "musicgen-medium": (4, "float32", "float32"),
    "qwen1.5-32b": (8, "float32", "float32"),
    "qwen3-8b": (8, "float32", "float32"),
    "gemma-2b": (4, "float32", "float32"),
    "qwen2-72b": (16, "bfloat16", "bfloat16"),
    "rwkv6-7b": (8, "float32", "float32"),
    "qwen2-vl-72b": (16, "bfloat16", "bfloat16"),
}


def model_options_for(
    arch: ArchConfig, shape: ShapeConfig, kernel_mode: str = "kernel"
) -> ModelOptions:
    base = arch.name.replace("-smoke", "")
    _, param_dtype, _ = _TRAIN_TABLE.get(base, (1, "float32", "float32"))
    if shape.kind != "train":
        param_dtype = "bfloat16"  # serving holds bf16 weights only
    return ModelOptions(
        kernel_mode=kernel_mode,
        remat=shape.kind == "train",
        ssm_chunk=128,
        wkv_chunk=64,
        moe_group=4096,
        attn_q_chunk=1024 if shape.kind == "prefill" else 4096,
        loss_chunk=512,
        # serving stores the KV cache as int8 (+fp16 scales) end to end:
        # prefill emits it, decode reads and extends it
        kv_quantized=shape.kind in ("decode", "prefill"),
        compute_dtype="bfloat16",
        param_dtype=param_dtype,
    )


def train_run_config_for(arch: ArchConfig, shape: ShapeConfig) -> TrainRunConfig:
    base = arch.name.replace("-smoke", "")
    mb, _, accum = _TRAIN_TABLE.get(base, (1, "float32", "float32"))
    mb = min(mb, shape.global_batch)
    return TrainRunConfig(num_microbatches=mb, accum_dtype=accum)


def adamw_config_for(arch: ArchConfig) -> AdamWConfig:
    base = arch.name.replace("-smoke", "")
    _, param_dtype, _ = _TRAIN_TABLE.get(base, (1, "float32", "float32"))
    # >=100B archs hold Adam moments in bf16 (2+2+2 B/param with bf16 params)
    state_dtype = "bfloat16" if param_dtype == "bfloat16" else "float32"
    return AdamWConfig(lr=3e-4, warmup_steps=200, total_steps=50_000, state_dtype=state_dtype)
