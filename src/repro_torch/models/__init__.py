"""Model zoo of the port (dense decoder family so far)."""
from repro_torch.models.model import Model, ModelOptions, build_model

__all__ = ["Model", "ModelOptions", "build_model"]
