"""Eval registry: ``eval_name`` -> eval main callable.

Counterpart of ``avjepa_tpu/evals/__init__.py`` (reference:
evals/scaffold.py). Ported: ``av_prediction``. The two frozen classification
evals are listed so that a config naming one fails with a clear message.
Every eval takes ``device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Callable


def _av_prediction(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.evals.av_prediction import main

    return main(args, resume_preempt, device=device)


def _not_ported(name: str) -> Callable:
    def main(args: dict, resume_preempt: bool = False, device="cuda"):
        raise NotImplementedError(
            f"eval '{name}' is not ported to avjepa_tpu_torch yet (see ROADMAP.md); run it "
            f"with the JAX package: python -m avjepa_tpu.app.eval_main --fname ..."
        )

    return main


EVALS: dict[str, Callable] = {
    "video_classification_frozen": _not_ported("video_classification_frozen"),
    "image_classification_frozen": _not_ported("image_classification_frozen"),
    "av_prediction": _av_prediction,
}
