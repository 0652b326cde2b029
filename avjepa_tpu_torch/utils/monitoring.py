"""Host resource monitoring (the port's copy of
``avjepa_tpu/utils/monitoring.py``, standard library only): a daemon thread
samples /proc every few seconds and writes a CSV next to the logs. The
pretrain app starts it under ``data.log_resource_utilization``, one file a
rank (``<tag>_resources_r{rank}.csv``).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Callable, Optional


@dataclasses.dataclass
class ResourceSample:
    timestamp: float
    cpu_percent: float
    rss_mb: float
    read_mb: float
    write_mb: float
    num_threads: int


def _read_proc_stat() -> tuple[float, float]:
    """(process cpu seconds, wall time)."""
    with open("/proc/self/stat") as f:
        parts = f.read().split()
    tick = os.sysconf("SC_CLK_TCK")
    utime, stime = int(parts[13]), int(parts[14])
    return (utime + stime) / tick, time.time()


def _read_proc_status() -> tuple[float, int]:
    rss_kb = 0
    threads = 0
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                rss_kb = int(line.split()[1])
            elif line.startswith("Threads:"):
                threads = int(line.split()[1])
    return rss_kb / 1024.0, threads


def _read_proc_io() -> tuple[float, float]:
    rb = wb = 0
    try:
        with open("/proc/self/io") as f:
            for line in f:
                if line.startswith("read_bytes:"):
                    rb = int(line.split()[1])
                elif line.startswith("write_bytes:"):
                    wb = int(line.split()[1])
    except OSError:
        pass
    return rb / 1e6, wb / 1e6


class ResourceMonitor:
    """Samples host resources every ``interval`` seconds until stopped."""

    def __init__(
        self,
        interval: float = 5.0,
        log_path: Optional[str] = None,
        callback: Optional[Callable[[ResourceSample], None]] = None,
    ):
        self.interval = interval
        self.log_path = log_path
        self.callback = callback
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.samples: list[ResourceSample] = []

    def start(self):
        if self.log_path:
            with open(self.log_path, "w") as f:
                f.write("timestamp,cpu_percent,rss_mb,read_mb,write_mb,threads\n")
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        cpu0, t0 = _read_proc_stat()
        while not self._stop.wait(self.interval):
            cpu1, t1 = _read_proc_stat()
            dt = max(t1 - t0, 1e-9)
            pct = 100.0 * (cpu1 - cpu0) / dt
            cpu0, t0 = cpu1, t1
            rss, threads = _read_proc_status()
            rmb, wmb = _read_proc_io()
            s = ResourceSample(t1, pct, rss, rmb, wmb, threads)
            self.samples.append(s)
            if self.callback:
                self.callback(s)
            if self.log_path:
                with open(self.log_path, "a") as f:
                    f.write(
                        f"{s.timestamp:.1f},{s.cpu_percent:.1f},{s.rss_mb:.1f},"
                        f"{s.read_mb:.1f},{s.write_mb:.1f},{s.num_threads}\n"
                    )

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2 * self.interval)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
