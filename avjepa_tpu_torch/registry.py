"""App registry: string key -> app main callable.

Counterpart of ``avjepa_tpu/registry.py``: every app of the JAX package
(the ``avjepa`` and ``vjepa`` pretrain apps, ``avprediction`` and
``avprediction_example``, ``extract``), and ``eval_main`` over the eval
registry (``evals/__init__.py``). Every app and eval takes ``device``
(default ``cuda``).
"""

from __future__ import annotations

from typing import Callable


def _pretrain(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.train.pretrain import main

    return main(args, resume_preempt, device=device)


def _extract(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.serve.extract import main

    return main(args, resume_preempt, device=device)


def _avprediction(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.train.avprediction import main

    return main(args, resume_preempt, device=device)


def _avprediction_example(args: dict, resume_preempt: bool = False, device="cuda"):
    from avjepa_tpu_torch.train.avprediction import example_main

    return example_main(args, resume_preempt, device=device)


APPS: dict[str, Callable] = {
    "avjepa": _pretrain,
    "vjepa": _pretrain,
    "avprediction": _avprediction,
    "avprediction_example": _avprediction_example,
    "extract": _extract,
}


def app_main(app: str, args: dict, resume_preempt: bool = False, device="cuda"):
    if app not in APPS:
        raise KeyError(f"unknown app '{app}'; available: {sorted(APPS)}")
    return APPS[app](args, resume_preempt, device=device)


def eval_main(eval_name: str, args: dict, resume_preempt: bool = False, device="cuda"):
    """Eval registry (reference: evals/scaffold.py:16-24)."""
    from avjepa_tpu_torch.evals import EVALS

    if eval_name not in EVALS:
        raise KeyError(f"unknown eval '{eval_name}'; available: {sorted(EVALS)}")
    return EVALS[eval_name](args, resume_preempt, device=device)
