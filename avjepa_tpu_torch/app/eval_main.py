"""Eval CLI: ``python -m avjepa_tpu_torch.app.eval_main --fname eval_cfg.yaml``.

Counterpart of ``avjepa_tpu/app/eval_main.py:17-42`` (reference parity:
evals/main.py, ``--fname`` and ``eval_name`` dispatch), plus ``--device``
(default ``cuda``; the CPU must be asked for). ``AVJEPA_RESUME_PREEMPT=1``
passes ``resume_preempt`` to the eval.
"""

from __future__ import annotations

import argparse

import yaml


def launch(fname: str, device: str = "cuda"):
    from avjepa_tpu_torch.registry import eval_main
    from avjepa_tpu_torch.utils import env_flag
    from avjepa_tpu_torch.utils.device import resolve_device
    from avjepa_tpu_torch.utils.logging import get_logger

    logger = get_logger("avjepa_tpu_torch")
    with open(fname) as f:
        params = yaml.safe_load(f)
    eval_name = params.get("eval_name")
    device = resolve_device(device)
    resume_preempt = env_flag("AVJEPA_RESUME_PREEMPT")
    if resume_preempt:
        logger.info("AVJEPA_RESUME_PREEMPT=1: resuming the probe")
    logger.info(f"running eval '{eval_name}' on {device}")
    return eval_main(eval_name, params, resume_preempt=resume_preempt, device=device)


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--fname", type=str, required=True)
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (default cuda; cpu must be asked for)",
    )
    args = parser.parse_args()
    launch(args.fname, args.device)
