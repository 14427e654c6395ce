"""Parameter conversion: a JAX param pytree, given as numpy arrays (or
anything ``np.asarray`` takes), becomes the port's nested dict of tensors
with the same leaf names and layout (``(d_in, d_out)`` weights, stacked
``(n_layers, ...)`` layer leaves)."""
from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch


def from_jax(tree: Any, device: Union[str, torch.device]) -> Any:
    """Leaf for leaf: ``torch.from_numpy(np.asarray(leaf))`` on ``device``,
    nested dicts kept as they are."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    # np.array copies: the source may be a read-only view of a JAX buffer
    return torch.from_numpy(np.array(tree)).to(device)
