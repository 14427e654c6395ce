"""Model zoo of the port: every family of the JAX package's registry."""
from repro_torch.models.model import Model, ModelOptions, build_model

__all__ = ["Model", "ModelOptions", "build_model"]
