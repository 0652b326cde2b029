"""CLI launcher: ``python -m avjepa_tpu_torch.app.main --fname cfg.yaml``.

Same YAML schema and CLI shape as ``avjepa_tpu/app/main.py``. One process
drives one device: the GPU (``--device cuda``, the default), or the CPU when
``--device cpu`` asks for it. Several GPUs, one process each over
``torch.distributed``, run through ``app/main_distributed.py``.
``AVJEPA_RESUME_PREEMPT=1`` passes ``resume_preempt`` to the app, which then
resumes from its latest checkpoint (a SIGTERM'd run requeued by its
supervisor).
"""

from __future__ import annotations

import argparse
import os

import yaml


def launch(fname: str, dump_dir: str | None = None, device: str = "cuda"):
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.registry import app_main
    from avjepa_tpu_torch.utils import env_flag
    from avjepa_tpu_torch.utils.device import resolve_device
    from avjepa_tpu_torch.utils.logging import get_logger

    logger = get_logger("avjepa_tpu_torch")
    logger.info(f"loading config {fname}")
    with open(fname) as f:
        params = yaml.safe_load(f)

    cfg = load_config(params)
    device = resolve_device(device)
    # dump the effective params next to the logs, as the JAX launcher does
    folder = dump_dir or cfg.logging.folder
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "params-pretrain.yaml"), "w") as f:
        yaml.safe_dump(params, f)

    logger.info(f"launching app '{cfg.app}' on {device}")
    resume_preempt = env_flag("AVJEPA_RESUME_PREEMPT")
    if resume_preempt:
        logger.info("AVJEPA_RESUME_PREEMPT=1: resuming from latest checkpoint")
    return app_main(cfg.app, params, resume_preempt=resume_preempt, device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fname", type=str, required=True, help="yaml config path")
    parser.add_argument(
        "--folder", type=str, default=None, help="override log/dump folder"
    )
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device to run on (default cuda; cpu must be asked for)",
    )
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    launch(args.fname, args.folder, args.device)
