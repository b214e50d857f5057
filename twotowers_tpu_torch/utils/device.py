"""The device an entry point runs on: the card unless the caller says so."""

from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it names CUDA and no
    card is present. Nothing falls back to the CPU unless it was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} needs a CUDA card and none is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
