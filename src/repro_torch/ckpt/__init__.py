"""Checkpointing for the port (the JAX package's ``ckpt``)."""
from repro_torch.ckpt.checkpoint import CheckpointManager  # noqa: F401
