"""Which device the apps run on: the GPU, unless the caller asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist. There is
    no quiet fall back to the CPU: the CPU runs only when it is asked for
    (``--device cpu``, ``device="cpu"``), as the tests do."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available on this machine; to run on the CPU, ask for it "
                "with --device cpu (device='cpu')"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device
