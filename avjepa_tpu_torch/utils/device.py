"""Which device the apps run on."""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The first GPU when there is one, else the CPU (tests and tiny runs).
    On a GPU every attention kernel launches on the card or raises; nothing
    falls back to the CPU."""
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
