"""Data-parallel and batch launcher, one process per GPU.

    torchrun --nproc-per-node 8 -m avjepa_tpu_torch.app.main_distributed \\
        --fname configs/pretrain/av-vitl16.yaml
    python -m avjepa_tpu_torch.app.main_distributed --nproc-per-node 8 \\
        --fname cfg1.yaml eval1.yaml --batch-launch

Counterpart of ``avjepa_tpu/app/main_distributed.py`` (reference:
app/main_distributed.py). The JAX package runs one process per host over its
local devices; the port runs one process per GPU over ``torch.distributed``
(``parallel/dist.py``), so a rank here is what a host is there:
- under torchrun (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT`` set) this process is one rank: it joins the process group
  (NCCL on CUDA, gloo with ``--device cpu``) on ``cuda:LOCAL_RANK``; a local
  rank with no GPU raises;
- ``--nproc-per-node N`` starts the N ranks of this host itself, as
  torchrun's standalone mode does, forwards a SIGTERM to them, and exits
  with the first failing rank's code after stopping the others;
- without either it runs in this process, with no process group.
The JAX launcher's capabilities are kept: ``--fname`` with several configs
run in order under ``--batch-launch``; ``--folder`` overrides each config's
``logging.folder``; ``--resume-preempt`` (or ``AVJEPA_RESUME_PREEMPT``)
resumes each run from its latest checkpoint; eval configs (those with an
``eval_name``) go to the eval registry. ``--report-dir`` writes each rank's
``report_r{rank}.json``: its world, backend and device, each run's summary,
the kernels' launch counts and the collectives in this process, and its
peak device memory.

A pretrain or avprediction config with ``tpu.mesh_fsdp: N`` shards the
models over N ranks (``parallel/fsdp.py``; with ``mesh_data`` also
above 1, FSDP2's HSDP); with ``tpu.mesh_tensor: T`` each group of T
consecutive ranks splits every block's heads and MLP width and loads one
batch (``parallel/tensor.py``), so the global batch is ``batch_size x
mesh_data x mesh_fsdp``; the three axes multiply to the ranks, or the run
raises. Extract and the classification evals ignore the mesh keys and stay
data parallel, as the JAX evals run on ``eval_mesh``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import time

import yaml


def launch_one(fname: str, folder: str | None, resume_preempt: bool, device):
    from avjepa_tpu_torch.parallel import dist
    from avjepa_tpu_torch.registry import app_main, eval_main
    from avjepa_tpu_torch.utils.logging import get_logger

    logger = get_logger("avjepa_tpu_torch")
    with open(fname) as f:
        params = yaml.safe_load(f)
    if folder:
        # a bare 'logging:' key parses to None
        if params.get("logging") is None:
            params["logging"] = {}
        params["logging"]["folder"] = folder
    where = f"[rank {dist.rank()}/{dist.world()}]"
    if "eval_name" in params:
        logger.info(f"{where} launching eval '{params['eval_name']}' from {fname} on {device}")
        return eval_main(params["eval_name"], params, resume_preempt=resume_preempt,
                         device=device)
    app = params.get("app", "avjepa")
    logger.info(f"{where} launching '{app}' from {fname} on {device} "
                f"(resume_preempt={resume_preempt})")
    return app_main(app, params, resume_preempt=resume_preempt, device=device)


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--fname", type=str, nargs="+", required=True,
                        help="one or more yaml configs")
    parser.add_argument("--folder", type=str, default=None)
    parser.add_argument("--batch-launch", action="store_true",
                        help="run all configs in order (reference batch mode)")
    parser.add_argument("--resume-preempt", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default: cuda:LOCAL_RANK) or cpu, which must be asked for")
    parser.add_argument("--nproc-per-node", type=int, default=0,
                        help="start this many ranks on this host")
    parser.add_argument("--dist-timeout", type=float, default=600.0,
                        help="seconds a collective or the rendezvous may wait")
    parser.add_argument("--report-dir", type=str, default=None,
                        help="write report_r{rank}.json there")
    return parser.parse_args(argv)


def _child_argv(args) -> list[str]:
    out = ["--fname", *args.fname, "--device", args.device,
           "--dist-timeout", str(args.dist_timeout)]
    if args.folder:
        out += ["--folder", args.folder]
    if args.batch_launch:
        out.append("--batch-launch")
    if args.resume_preempt:
        out.append("--resume-preempt")
    if args.report_dir:
        out += ["--report-dir", args.report_dir]
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(args) -> int:
    """Start ``args.nproc_per_node`` ranks of this module and wait for
    them; returns 0, or the exit code of the first rank that failed (the
    others are killed: they would wait in a collective)."""
    n = args.nproc_per_node
    if args.device.startswith("cuda"):
        import torch

        if torch.cuda.device_count() < n:
            raise RuntimeError(f"--nproc-per-node {n} on CUDA, but this host has "
                               f"{torch.cuda.device_count()} GPU(s); to run on the CPU, "
                               "ask for it with --device cpu")
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = os.environ.get("MASTER_PORT") or str(_free_port())
    # the ranks share the host's cores (torchrun sets 1 thread a rank): N
    # ranks each spinning a thread per core slow each other down a hundredfold
    threads = os.environ.get("OMP_NUM_THREADS") or str(max(1, (os.cpu_count() or 1) // n))
    procs = []
    for r in range(n):
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(n),
                   LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                   OMP_NUM_THREADS=threads,
                   PYTHONPATH=os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH"))
                                              if p))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "avjepa_tpu_torch.app.main_distributed", *_child_argv(args)],
            env=env))

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    prev = signal.signal(signal.SIGTERM, forward)
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
                print(f"main_distributed: a rank exited with {failed[0]}; stopped the others",
                      file=sys.stderr)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.2)
    finally:
        signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None):
    """Run the configs on this rank (or start the ranks); returns the runs'
    summaries, or the ranks' exit code under ``--nproc-per-node``."""
    args = parse_args(argv)
    if args.nproc_per_node:
        return spawn(args)

    from avjepa_tpu_torch.parallel import dist
    from avjepa_tpu_torch.utils import env_flag
    from avjepa_tpu_torch.utils.device import resolve_device

    if "WORLD_SIZE" in os.environ:
        device = dist.init_distributed(args.device, timeout_s=args.dist_timeout)
    else:
        device = resolve_device(args.device)
    try:
        resume = args.resume_preempt or env_flag("AVJEPA_RESUME_PREEMPT")
        configs = args.fname if args.batch_launch else args.fname[:1]
        summaries = [launch_one(fname, args.folder, resume, device) for fname in configs]
        if args.report_dir:
            _report(args.report_dir, device, summaries)
        return summaries
    finally:
        dist.shutdown()


def _report(folder: str, device, summaries: list) -> None:
    import torch
    import torch.distributed

    from avjepa_tpu_torch.ops import flash_attention, layer_norm
    from avjepa_tpu_torch.parallel import dist

    os.makedirs(folder, exist_ok=True)
    report = {
        "rank": dist.rank(), "world": dist.world(), "device": str(device),
        "backend": torch.distributed.get_backend() if dist.active() else None,
        "summaries": summaries,
        "launches": {**flash_attention.LAUNCHES, **layer_norm.LAUNCHES},
        "reductions": dict(dist.REDUCTIONS),
        "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                     if torch.device(device).type == "cuda" else None),
    }
    with open(os.path.join(folder, f"report_r{dist.rank()}.json"), "w") as f:
        json.dump(report, f, default=str)


if __name__ == "__main__":
    out = main()
    sys.exit(out if isinstance(out, int) else 0)
