"""Logging, metering, and step timing (the port's copy of
``avjepa_tpu/utils/logging.py``).

Parity with reference src/utils/logging.py:14-118 (CSVLogger, AverageMeter,
gpu_timer); grad/optimizer statistics are computed in train/step.py.
"""

from __future__ import annotations

import logging
import os
import sys
import time


def get_logger(name: str | None = None, rank: int | None = None) -> logging.Logger:
    """The named logger writing to stdout: INFO on rank 0, ERROR only on the
    other ranks; ``rank`` defaults to this process's ``RANK`` (torchrun's
    environment, 0 without it)."""
    if rank is None:
        rank = int(os.environ.get("RANK", "0"))
    logger = logging.getLogger(name or "avjepa_tpu")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(
            logging.Formatter("[%(asctime)s %(levelname)s] %(message)s")
        )
        logger.addHandler(handler)
    # don't ALSO propagate to the root logger, which may have a handler of
    # its own: every record would be emitted twice
    logger.propagate = False
    logger.setLevel(logging.INFO if rank == 0 else logging.ERROR)
    return logger


class CSVLogger:
    """Append-only typed-column CSV (reference: logging.py:44-62)."""

    def __init__(self, fname: str, *argv):
        self.fname = fname
        self.types = []
        with open(fname, "+a") as f:
            for i, v in enumerate(argv, 1):
                self.types.append(v[0])
                end = "," if i < len(argv) else "\n"
                print(v[1], end=end, file=f)

    def log(self, *argv):
        with open(self.fname, "+a") as f:
            for i, tv in enumerate(zip(self.types, argv), 1):
                end = "," if i < len(argv) else "\n"
                print(tv[0] % tv[1], end=end, file=f)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.max = float("-inf")
        self.min = float("inf")
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        try:
            self.max = max(val, self.max)
            self.min = min(val, self.min)
        except Exception:
            pass
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class StepTimer:
    """Wall-clock timer around a step that ends in a device synchronize (the
    reference's gpu_timer, logging.py:14-31, times with CUDA events)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed_ms = (time.perf_counter() - self.start) * 1000.0
        return False
