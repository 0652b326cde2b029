"""ViT-H (configs/pretrain/vith16.yaml) sharded by avjepa_tpu_torch over
several GPUs with NCCL: the fsdp and tensor axes measured where
chip_smoke.py, which needs one card, cannot.

    python tools/torch_fsdp_cards.py [--cards 4] [--steps 6] [--compare-root DIR] [--tensor]

from the root of a checkout, on a machine with ``--cards`` GPUs. It builds
the kernels and runs chip_smoke.py's phase 13 (a) (the unsharded step on one
card, which also saves the batch); then, for ``tpu.mesh_fsdp: cards`` and a
2 x (cards / 2) (data, fsdp) mesh, ``--steps`` steps through
``python -m avjepa_tpu_torch.app.main_distributed --nproc-per-node cards``
(step ms from the CSV, each rank's peak memory from its report), and the
mesh's ranks on (a)'s batch: two steps beside the unsharded first step, each
rank's peak memory, and one profiled step's NCCL share of the device time.
With ``--tensor`` the meshes are fsdp 2 x tensor (cards / 2) and tensor
``cards`` (``tpu.mesh_tensor``) instead, at the same global batch of 24.
With ``--compare-root`` (another checkout of the repo, with the same kernel
sources), the main_distributed runs are also made from that tree, in the
order other, this, this, other for the fsdp mesh and other, this for the
2 x (cards / 2) one, so that the two compare within one machine's run. Logs
and profiles go to chiprun_out/.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def run_main_distributed(workdir: str, cards: int, data: int, fsdp_: int, steps: int,
                         root: str = ROOT, label: str = "this", tensor_: int = 1) -> list:
    """``steps`` steps of vith16.yaml at a global batch of 24 (24 / (data x
    fsdp_) a rank) through main_distributed run from the checkout ``root``;
    prints and returns the step ms of the CSV (host clock to each step's
    sync)."""
    import yaml

    name = f"{label}-{data}x{fsdp_}x{tensor_}-{len(os.listdir(workdir))}"
    d = cs._vith_cfg(workdir, 24 // (data * fsdp_), tpu={"mesh_data": data, "mesh_fsdp": fsdp_,
                                                         "mesh_tensor": tensor_},
                     optimization={"ipe": steps, "epochs": 1})
    d["logging"]["folder"] = os.path.join(workdir, f"vith-{name}")
    path = os.path.join(workdir, f"vith-{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    report_dir = os.path.join(workdir, f"report-{name}")
    res = subprocess.run(
        [sys.executable, "-m", "avjepa_tpu_torch.app.main_distributed", "--nproc-per-node",
         str(cards), "--report-dir", report_dir, "--fname", path],
        cwd=root, capture_output=True, text=True, timeout=900)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"vith_{name}_launcher.log"), "w") as f:
        f.write(res.stdout + res.stderr)
    if res.returncode != 0:
        raise AssertionError(f"main_distributed {name} exited {res.returncode}:\n"
                             f"{(res.stdout + res.stderr)[-3000:]}")
    rows = cs._csv_rows(os.path.join(d["logging"]["folder"],
                                     f"{d['logging']['write_tag']}_r0.csv"))
    peaks = []
    for r in range(cards):
        with open(os.path.join(report_dir, f"report_r{r}.json")) as f:
            peaks.append(json.load(f)["peak_gib"])
    ms = [float(row["step-time-ms"]) for row in rows]
    print(f"vith16 {data}x{fsdp_}x{tensor_} ({label} tree) through main_distributed on {cards} "
          f"cards: "
          f"step ms {ms} (CSV, host clock to the step's sync; median of steps 2-{len(ms)} "
          f"{cs._median_step_ms(rows):.1f}), losses {[float(row['loss']) for row in rows]}, "
          f"peak GiB by rank {[round(p, 2) for p in peaks]}; {cs.card_line()}", flush=True)
    return ms


def run_ranks(workdir: str, cards: int, data: int, fsdp_: int, vith: dict,
              tensor_: int = 1) -> None:
    """The mesh's ranks on phase 13 (a)'s batch (``chip_smoke.fsdp_rank``):
    two steps beside the unsharded first step, then a profiled step."""
    ranks = cs._spawn_fsdp_ranks(workdir, cards, data, fsdp_, profile=True, tensor_=tensor_)
    r0 = ranks[0]
    # a tensor group's ranks hold different pieces: the same losses, and the
    # same weights among the ranks of one tensor index
    if any(r["steps"][-1]["loss"] != r0["steps"][-1]["loss"] for r in ranks) or any(
            r["steps"][-1]["digest"] != ranks[i % tensor_]["steps"][-1]["digest"]
            for i, r in enumerate(ranks)):
        raise AssertionError(f"{data}x{fsdp_}x{tensor_}: the ranks' losses or weights differ")
    want = vith["first"]
    rel = {k: abs(r0["steps"][0][k] - want[k]) / abs(want[k])
           for k in ("loss", "enc_grad_norm", "pred_grad_norm")}
    print(f"vith16 {data}x{fsdp_}x{tensor_} ranks: steps {[step['ms'] for step in r0['steps']]} "
          f"ms, tensor all-reduces a step {[step['tensor_reductions'] for step in r0['steps']]}, "
          f"losses {[step['loss'] for step in r0['steps']]}, enc grad norms "
          f"{[step['enc_grad_norm'] for step in r0['steps']]}; step 1 against the unsharded "
          f"step at batch 24: rel {', '.join(f'{k} {v:.2e}' for k, v in rel.items())}; peak "
          f"GiB by rank {[round(r['peak_gib'], 2) for r in ranks]}; profiled step "
          f"{r0['profile_device_ms']:.1f} ms of device kernels, NCCL "
          f"{r0['profile_nccl_ms']:.1f} ms "
          f"({100 * r0['profile_nccl_ms'] / r0['profile_device_ms']:.1f}%); encoder "
          f"parameters held a rank {r0['encoder_local_params']:,}", flush=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cards", type=int, default=4)
    parser.add_argument("--steps", type=int, default=6)
    parser.add_argument("--compare-root", type=str, default=None,
                        help="another checkout whose runs are timed beside this one's")
    parser.add_argument("--tensor", action="store_true",
                        help="the tensor axis instead: fsdp 2 x tensor cards/2, and tensor cards")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
        cs.fail(f"needs {args.cards} GPUs, found "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    cs.toolchain()
    cs.build()
    if args.compare_root:
        # the same kernel sources build to the same files: share this tree's
        build_dir = os.path.join(os.path.abspath(args.compare_root), "avjepa_tpu_torch",
                                 "_build")
        if not os.path.exists(build_dir):
            os.symlink(os.path.join(ROOT, "avjepa_tpu_torch", "_build"), build_dir)
    with tempfile.TemporaryDirectory(prefix="fsdp_cards_") as workdir:
        vith = cs.run_vith(workdir)
        other, this = (args.compare_root, "other"), (ROOT, "this")
        meshes = ((1, args.cards, 1), (2, args.cards // 2, 1))
        if args.tensor:
            meshes = ((1, 2, args.cards // 2), (1, 1, args.cards))
        for data, fsdp_, tensor_ in meshes:
            order = [this]
            if args.compare_root:
                order = [other, this, this, other] if data == 1 else [other, this]
            for root, label in order:
                run_main_distributed(workdir, args.cards, data, fsdp_, args.steps, root, label,
                                     tensor_)
            run_ranks(workdir, args.cards, data, fsdp_, vith, tensor_)
    print(cs.card_line())


if __name__ == "__main__":
    main()
