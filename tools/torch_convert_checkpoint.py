"""Convert pretrain checkpoints between the port's ``.pth.tar`` and the JAX
package's Orbax directories, without JAX: the counterpart of
``tools/convert_reference_checkpoint.py``, through the port's own Orbax
reader and writer (``avjepa_tpu_torch/utils/orbax.py``).

  python tools/torch_convert_checkpoint.py <in.pth.tar> <folder>/<tag>-ckpt [--ipe N]

writes the file's state as a ``JepaState`` at step ``step`` (a reference
file without one: ``epoch * ipe``) into the Orbax manager directory, the
layout the JAX pretrain app resumes (``meta.load_checkpoint``) and
avprediction and the evals read. The AdamW moments and counts go with it
when the file has the port's ``opt``; else they are zero, at count 0.

  python tools/torch_convert_checkpoint.py --export <orbax dir> <out.pth.tar> [--ipe N]

writes the latest committed step of a JAX pretrain directory as the port's
checkpoint dict: the three state dicts, ``step``, ``epoch = step // ipe``,
and ``opt``, the AdamW moments and counts keyed by parameter name
(``{"by_name": ...}``, which ``load_train_state`` maps onto its
optimizer). The port reads Orbax directories directly as well; this makes
a file for tools that read only ``.pth.tar``. Reading what Orbax wrote (zstd
compressed) needs ``libzstd.so.1`` on the host.
"""

from __future__ import annotations

import argparse
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def to_orbax(pth: str, directory: str, ipe: int = 1) -> int:
    """``pth`` -> step ``step`` of the Orbax manager ``directory`` (an
    existing step of that number is replaced). Returns the step."""
    import torch

    from avjepa_tpu_torch.utils import orbax
    from avjepa_tpu_torch.utils.checkpoint import jax_tree

    ckpt = torch.load(pth, map_location="cpu", weights_only=True)
    step = int(ckpt["step"]) if "step" in ckpt else int(ckpt.get("epoch", 0)) * ipe
    ckpt["step"] = step
    orbax.CheckpointManager(directory).save(step, jax_tree(ckpt), force=True)
    print(f"wrote step {step} of {pth} to {directory}")
    return step


def export(directory: str, out_path: str, ipe: int = 1) -> str:
    """The latest committed step of ``directory`` -> ``out_path``."""
    import torch

    from avjepa_tpu_torch.utils.checkpoint import read_checkpoint

    ckpt = read_checkpoint(directory)
    ckpt.update(scaler=None, epoch=ckpt["step"] // max(1, ipe), loss=0.0, batch_size=0,
                world_size=1, lr=0.0)
    torch.save(ckpt, out_path)
    print(f"exported step {ckpt['step']} of {directory} -> {out_path}")
    return out_path


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("src", help="a .pth.tar (with --export: an Orbax manager directory)")
    ap.add_argument("dst", help="the Orbax manager directory, <folder>/<tag>-ckpt (with "
                    "--export: the .pth.tar to write)")
    ap.add_argument("--export", action="store_true", help="Orbax directory -> .pth.tar")
    ap.add_argument("--ipe", type=int, default=1,
                    help="iterations per epoch: the step of a file without one, or "
                    "(--export) the epoch field")
    args = ap.parse_args(argv)
    if args.export:
        export(args.src, args.dst, args.ipe)
    else:
        to_orbax(args.src, args.dst, args.ipe)


if __name__ == "__main__":
    main()
