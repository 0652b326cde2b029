"""Eval registry: ``eval_name`` -> eval main callable.

Counterpart of ``avjepa_tpu/evals/__init__.py`` (reference:
evals/scaffold.py): the two frozen classification evals and
``av_prediction``. Every eval takes ``device`` (default ``cuda``).
"""

from __future__ import annotations

from typing import Callable


def _video_classification(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.evals.video_classification import main

    return main(args, resume_preempt, device=device)


def _image_classification(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.evals.image_classification import main

    return main(args, resume_preempt, device=device)


def _av_prediction(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.evals.av_prediction import main

    return main(args, resume_preempt, device=device)


EVALS: dict[str, Callable] = {
    "video_classification_frozen": _video_classification,
    "image_classification_frozen": _image_classification,
    "av_prediction": _av_prediction,
}
