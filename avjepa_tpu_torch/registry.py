"""App registry: string key -> app main callable.

Counterpart of ``avjepa_tpu/registry.py``. Ported: the ``avjepa`` and
``vjepa`` pretrain apps and ``extract``; the other apps of the JAX package
are listed so that a config naming one fails with a clear message instead of
a typo-style ``KeyError``. Every app takes ``device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Callable


def _pretrain(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.train.pretrain import main

    return main(args, resume_preempt, device=device)


def _extract(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.serve.extract import main

    return main(args, resume_preempt, device=device)


def _not_ported(app: str) -> Callable:
    def main(args: dict, resume_preempt: bool = False, device="cuda"):
        raise NotImplementedError(
            f"app '{app}' is not ported to avjepa_tpu_torch yet (see ROADMAP.md); "
            f"run it with the JAX package: python -m avjepa_tpu.app.main --fname ..."
        )

    return main


APPS: dict[str, Callable] = {
    "avjepa": _pretrain,
    "vjepa": _pretrain,
    "avprediction": _not_ported("avprediction"),
    "avprediction_example": _not_ported("avprediction_example"),
    "extract": _extract,
}


def app_main(app: str, args: dict, resume_preempt: bool = False, device="cuda"):
    if app not in APPS:
        raise KeyError(f"unknown app '{app}'; available: {sorted(APPS)}")
    return APPS[app](args, resume_preempt, device=device)
