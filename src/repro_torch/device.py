"""Which device the port runs on: the card, unless the caller asks for the
CPU. There is no fallback — without CUDA a request for the card raises."""
from __future__ import annotations

from typing import Optional, Union

import torch


def device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``torch.device("cuda")`` by default; ``cpu`` only when asked for
    (``device="cpu"``). Raises ``RuntimeError`` when CUDA is asked for (or
    defaulted to) and no CUDA device is present."""
    dev = torch.device(name if name is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
