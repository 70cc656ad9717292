"""Device choice for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
There is no silent fallback: without a card, a caller that did not pass
``device="cpu"`` gets an error, so a CPU run is always one someone asked for.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; raise if a CUDA device is asked for but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
