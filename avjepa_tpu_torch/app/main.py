"""CLI launcher: ``python -m avjepa_tpu_torch.app.main --fname cfg.yaml``.

Same YAML schema and CLI shape as ``avjepa_tpu/app/main.py``. One process
drives one GPU (or the CPU where no GPU is present); there is no
``torch.distributed`` yet.
"""

from __future__ import annotations

import argparse
import os

import yaml


def launch(fname: str, dump_dir: str | None = None):
    from avjepa_tpu.utils.logging import get_logger

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.registry import app_main
    from avjepa_tpu_torch.utils.device import default_device

    logger = get_logger("avjepa_tpu_torch")
    logger.info(f"loading config {fname}")
    with open(fname) as f:
        params = yaml.safe_load(f)

    cfg = load_config(params)
    # dump the effective params next to the logs, as the JAX launcher does
    folder = dump_dir or cfg.logging.folder
    os.makedirs(folder, exist_ok=True)
    with open(os.path.join(folder, "params-pretrain.yaml"), "w") as f:
        yaml.safe_dump(params, f)

    logger.info(f"launching app '{cfg.app}' on {default_device()}")
    return app_main(cfg.app, params)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fname", type=str, required=True, help="yaml config path")
    parser.add_argument(
        "--folder", type=str, default=None, help="override log/dump folder"
    )
    return parser.parse_args(argv)


if __name__ == "__main__":
    args = parse_args()
    launch(args.fname, args.folder)
