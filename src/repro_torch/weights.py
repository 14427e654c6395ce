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
    nested dicts kept as they are. A bfloat16 leaf (numpy's extension
    type, which ``torch.from_numpy`` does not take) crosses bit for bit
    as 16-bit words."""
    if isinstance(tree, dict):
        return {k: from_jax(v, device) for k, v in tree.items()}
    # np.array copies: the source may be a read-only view of a JAX buffer
    arr = np.array(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)
