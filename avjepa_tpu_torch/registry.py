"""App registry: string key -> app main callable.

Counterpart of ``avjepa_tpu/registry.py``. Only ``extract`` is ported so far;
the other apps of the JAX package are listed so that a config naming one
fails with a clear message instead of a typo-style ``KeyError``.
"""

from __future__ import annotations

from typing import Callable


def _extract(args: dict, resume_preempt: bool = False):
    from avjepa_tpu_torch.serve.extract import main

    return main(args, resume_preempt)


def _not_ported(app: str) -> Callable:
    def main(args: dict, resume_preempt: bool = False):
        raise NotImplementedError(
            f"app '{app}' is not ported to avjepa_tpu_torch yet (see ROADMAP.md); "
            f"run it with the JAX package: python -m avjepa_tpu.app.main --fname ..."
        )

    return main


APPS: dict[str, Callable] = {
    "avjepa": _not_ported("avjepa"),
    "vjepa": _not_ported("vjepa"),
    "avprediction": _not_ported("avprediction"),
    "avprediction_example": _not_ported("avprediction_example"),
    "extract": _extract,
}


def app_main(app: str, args: dict, resume_preempt: bool = False):
    if app not in APPS:
        raise KeyError(f"unknown app '{app}'; available: {sorted(APPS)}")
    return APPS[app](args, resume_preempt)
