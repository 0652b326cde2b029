"""The whole user journey of avjepa_tpu_torch on real media files, through
the port's CLIs: the counterpart of ``tools/run_chain.py``.

  1. media      - N class-separable AV clips written with the port's libav
                  writer (avjepa_tpu_torch/data/video_decoder.py::
                  write_av_clip), plus train/val index CSVs ("path label")
  2. pretrain   - ``python -m avjepa_tpu_torch.app.main`` (AV JEPA, worker
                  processes decoding the files); writes
                  <workdir>/pretrain/chain-latest.pth.tar
  3. roundtrip  - the crossing port -> JAX -> port: the port's Orbax
                  writer (tools/torch_convert_checkpoint.py) turns that
                  .pth.tar into the JAX app's <tag>-ckpt, the JAX package's
                  manager restores it and saves it again (a subprocess),
                  and the target encoder the port reads from that save
                  must equal the original to the bit
  4. eval       - ``python -m avjepa_tpu_torch.app.eval_main``: the frozen
                  video-classification probe on the pretrained encoder
  5. control    - the same probe on a random encoder
  6. avpred     - the avprediction probe on the frozen pretrained JEPA
  7. example    - avprediction_example's reconstruction .npz
  8. extract    - the extract service over the val clips

Each stage is a subprocess with its log under <workdir>/logs/, run on
``--device`` (default cuda; ``--device cpu`` runs it all on the CPU). The
crossing's middle step needs JAX and Orbax on the host and fails without
them; the rest imports nothing of JAX. Decoding and writing media need libav
(``make -C native``). Prints one summary JSON line with the JAX tool's keys.
The defaults are the JAX tool's CI geometry (vit_tiny, 100 clips, crop 64,
8 frames, 300 probe epochs); ``--model vit_large --crop 224 --frames 16
--batch 24`` is the flagship chain.

Usage: python tools/torch_run_chain.py [--workdir DIR] [--clips N] [--device cpu] ...
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import yaml

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)


def sh(stage: str, argv: list[str], workdir: str, env=None) -> float:
    log = os.path.join(workdir, "logs", f"{stage}.log")
    os.makedirs(os.path.dirname(log), exist_ok=True)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.call(argv, stdout=f, stderr=subprocess.STDOUT,
                             cwd=_REPO, env=env)
    dt = time.perf_counter() - t0
    if rc != 0:
        tail = open(log).read()[-4000:]
        raise RuntimeError(f"stage {stage} failed (rc={rc}):\n{tail}")
    print(f"[chain] {stage}: ok ({dt:.1f}s, log {log})", flush=True)
    return dt


def class_av_content(label: int, rng: np.random.Generator, n_frames: int,
                     w: int, h: int, fps: float = 25.0, sr: int = 22050):
    """Author one clip with genuinely class-separable AV statistics.

    The class signal is SPATIO-TEMPORAL (motion direction), not a static cue
    a random frozen encoder could trivially carry to the probe, and it is
    present in both modalities:
      class 0: grating drifts RIGHT;  tone ~420 Hz
      class 1: grating drifts LEFT;   tone ~950 Hz
      class 2: grating drifts DOWN;   tone ~2100 Hz
    Per-clip randomness (spatial frequency, phase, contrast, speed, texture
    noise, tone jitter/AM) keeps individual clips distinct within a class.
    """
    y, x = np.meshgrid(
        np.linspace(0, 2 * np.pi, h, dtype=np.float32),
        np.linspace(0, 2 * np.pi, w, dtype=np.float32),
        indexing="ij",
    )
    fx = rng.uniform(2.0, 4.0)
    fy = rng.uniform(0.0, 1.0)
    phase0 = rng.uniform(0, 2 * np.pi)
    speed = rng.uniform(0.5, 0.9)  # radians/frame — several px/frame drift
    contrast = rng.uniform(80, 120)
    # sin(fx*x + d*s*t) drifts RIGHT when d<0 (phase x_shift = -d*s*t/fx)
    dir_v = {0: -1.0, 1: +1.0, 2: 0.0}[label]
    texture = rng.normal(0, 12, (h, w, 1)).astype(np.float32)  # static, per clip
    frames_u8 = np.empty((n_frames, h, w, 3), np.uint8)
    for t in range(n_frames):
        if label < 2:  # horizontal drift, sign = class
            arg = fx * x + fy * y + phase0 + dir_v * speed * t
        else:  # vertical drift
            arg = fx * y + fy * x + phase0 + speed * t
        img = 127.5 + contrast * np.sin(arg)[..., None] + texture
        img = img + rng.normal(0, 6, (h, w, 1))
        frames_u8[t] = np.clip(img, 0, 255).astype(np.uint8)

    n_samp = int(n_frames / fps * sr)
    tt = np.arange(n_samp, dtype=np.float32) / sr
    f0 = {0: 420.0, 1: 950.0, 2: 2100.0}[label] * rng.uniform(0.92, 1.08)
    am = 1.0 + 0.3 * np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * tt)
    pcm = 0.4 * am * np.sin(2 * np.pi * f0 * tt + rng.uniform(0, 2 * np.pi))
    pcm = pcm + rng.normal(0, 0.02, n_samp)
    return frames_u8, pcm.astype(np.float32), sr


def class_av_content_envelope(label: int, rng: np.random.Generator,
                              n_frames: int, w: int, h: int,
                              fps: float = 25.0, sr: int = 22050):
    """Drift-balanced (second-order motion) class media.

    The round-5 control measurement showed the first-order `class_av_content`
    task is INVALID as a learning discriminator: an attentive probe is a
    quadratic function of the tokens, first-order motion direction is a
    quadratic statistic of the pixels (spatiotemporal motion energy), and a
    random frozen ViT preserves pixels well enough that the control probe
    hits 100% val top-1 even from 2 train clips per class. This task buries
    the class signal one nonlinearity deeper (Chubb-Sperling drift-balanced
    stimuli): a STATIC noise carrier is multiplied by a drifting CONTRAST
    envelope. For every carrier realization the two first-order sidebands
    carry equal energy in opposite directions, so no quadratic statistic of
    the pixels sees the envelope's direction — extracting it needs
    rectification first (4th order in pixels). A global camera-jitter random
    walk adds classless first-order motion on top to poison motion-energy
    shortcuts. JEPA pretraining, by contrast, must represent the envelope
    phase trajectory to predict masked target features, making the class
    signal linearly salient to the probe only AFTER learning:
      class 0: envelope phase drifts +omega / frame; tone ~420 Hz
      class 1: envelope phase drifts -omega / frame; tone ~950 Hz
      class 2: envelope phase random-walks (+-omega steps); tone ~2100 Hz
    Per-clip nuisance: carrier realization, envelope orientation (+-40 deg
    of horizontal so the drift sign is well-defined), spatial frequency,
    speed, modulation depth, jitter path, sensor noise.
    """
    jmax = 8  # camera-jitter bound, px at generation resolution
    yy, xx = np.meshgrid(
        np.arange(h, dtype=np.float32) / w,  # shared scale: cycles-per-width
        np.arange(w, dtype=np.float32) / w,
        indexing="ij",
    )
    theta = rng.uniform(-0.7, 0.7)  # envelope wavevector angle off +x
    kf = rng.uniform(1.5, 2.5)      # envelope cycles across the width
    kx = 2 * np.pi * kf * np.cos(theta)
    ky = 2 * np.pi * kf * np.sin(theta)
    omega = rng.uniform(0.35, 0.6)  # rad/frame of envelope phase
    m = rng.uniform(0.7, 0.9)       # modulation depth
    amp = rng.uniform(32, 44)       # carrier amplitude (gray levels)
    phase0 = rng.uniform(0, 2 * np.pi)
    # static noise carrier, lightly smoothed, oversized by the jitter bound
    big = rng.normal(0, 1, (h + 2 * jmax, w + 2 * jmax)).astype(np.float32)
    big = (big + np.roll(big, 1, 0) + np.roll(big, 1, 1)
           + np.roll(big, (1, 1), (0, 1))) / 2.0
    if label == 0:
        dphi = np.full(n_frames, omega, np.float32)
    elif label == 1:
        dphi = np.full(n_frames, -omega, np.float32)
    else:
        dphi = (omega * rng.choice([-1.0, 1.0], n_frames)).astype(np.float32)
    phases = phase0 + np.concatenate([[0.0], np.cumsum(dphi[:-1])])
    # integer camera-jitter random walk, clamped to the oversize margin
    steps = rng.integers(-3, 4, size=(n_frames, 2))
    jit = np.clip(np.cumsum(steps, 0), -jmax, jmax) + jmax
    frames_u8 = np.empty((n_frames, h, w, 3), np.uint8)
    grating = kx * xx + ky * yy
    for t in range(n_frames):
        jy, jx = int(jit[t, 0]), int(jit[t, 1])
        carrier = big[jy:jy + h, jx:jx + w]
        env = 1.0 + m * np.cos(grating - phases[t])
        img = 127.5 + amp * carrier * env
        img = img[..., None] + rng.normal(0, 5, (h, w, 1))
        frames_u8[t] = np.clip(img, 0, 255).astype(np.uint8)

    n_samp = int(n_frames / fps * sr)
    tt = np.arange(n_samp, dtype=np.float32) / sr
    f0 = {0: 420.0, 1: 950.0, 2: 2100.0}[label] * rng.uniform(0.92, 1.08)
    am = 1.0 + 0.3 * np.sin(2 * np.pi * rng.uniform(1.0, 3.0) * tt)
    pcm = 0.4 * am * np.sin(2 * np.pi * f0 * tt + rng.uniform(0, 2 * np.pi))
    pcm = pcm + rng.normal(0, 0.02, n_samp)
    return frames_u8, pcm.astype(np.float32), sr


def make_media(workdir: str, n_clips: int, w: int, h: int, frames: int,
               task: str = "envelope"):
    """N class-separable AV clips + train/val CSVs (3 balanced classes)."""
    from avjepa_tpu_torch.data.video_decoder import write_av_clip

    gen = {"grating": class_av_content,
           "envelope": class_av_content_envelope}[task]
    # task+geometry-suffixed dir: generation is resumable per file, so runs
    # that differ in task OR clip geometry must never share a directory (a
    # 160² CI run and a 256² flagship run in one workdir would otherwise
    # silently mix resolutions via the exists-check). "media" stays the
    # legacy grating location for warm round-3 workdirs.
    d = os.path.join(workdir, "media" if task == "grating"
                     else f"media_{task}_s{w}_f{frames}")
    os.makedirs(d, exist_ok=True)
    paths, labels = [], []
    for i in range(n_clips):
        label = i % 3
        p = os.path.join(d, f"clip{i:04d}_c{label}.avi")
        if not os.path.exists(p):  # media generation is resumable
            rng = np.random.default_rng([20260819, i])
            fr, pcm, sr = gen(label, rng, frames + (i % 5) * 8, w, h)
            write_av_clip(p, fr, 25.0, pcm, sr)
        paths.append(p)
        labels.append(label)
    n_train = max(1, int(0.8 * n_clips))
    train_csv = os.path.join(d, "train.csv")
    val_csv = os.path.join(d, "val.csv")
    with open(train_csv, "w") as f:
        f.write("".join(
            f"{p} {l}\n" for p, l in zip(paths[:n_train], labels[:n_train])
        ))
    with open(val_csv, "w") as f:
        f.write("".join(
            f"{p} {l}\n" for p, l in zip(paths[n_train:], labels[n_train:])
        ))
    return train_csv, val_csv


def last_csv_value(path: str, column: str) -> float:
    with open(path) as f:
        header = f.readline().strip().split(",")
        col = header.index(column)
        val = None
        for line in f:
            parts = line.strip().split(",")
            if len(parts) > col and parts[col]:
                val = float(parts[col])
    return val


def same_target_encoder(pth: str, other: str) -> int:
    """Asserts that the port reads the same target encoder from the two
    pretrain checkpoints (``.pth.tar`` files or Orbax directories), entry
    by entry and to the bit; returns the number of entries."""
    import torch

    from avjepa_tpu_torch.utils.checkpoint import load_encoder_checkpoint

    ours, theirs = (load_encoder_checkpoint(p, prefer="target_encoder") for p in (pth, other))
    if set(ours) != set(theirs):
        raise AssertionError(f"the entries differ: {sorted(set(ours) ^ set(theirs))}")
    for k in ours:
        if ours[k].dtype != theirs[k].dtype or not torch.equal(ours[k], theirs[k]):
            raise AssertionError(f"{k} differs between {pth} and {other}")
    return len(ours)


def jax_resave(src: str, dst: str) -> int:
    """The JAX side of the crossing: the JAX package's manager restores the
    latest step of the Orbax directory ``src`` and saves it again as that
    step of ``dst``. Needs JAX; ``cross_checkpoint`` runs it in a process
    of its own. Returns the step."""
    from avjepa_tpu.utils.checkpoint import CheckpointManager

    mngr = CheckpointManager(src)
    step = mngr.latest_step()
    CheckpointManager(dst).save(step, mngr.restore(None, step), force=True)
    print(f"JAX restored and saved step {step}")
    return step


def cross_checkpoint(pth: str, workdir: str, timings: dict) -> int:
    """port -> JAX -> port: the port's Orbax writer turns ``pth`` into
    <workdir>/crossing/port/chain-ckpt; the JAX package's manager restores
    that, in a subprocess on JAX's CPU backend, and saves it again to
    <workdir>/crossing/jax/chain-ckpt; the port must read the same target
    encoder from that directory as from ``pth`` (``same_target_encoder``).
    Returns the number of its entries."""
    folder = os.path.join(workdir, "crossing")
    ours, theirs = (os.path.join(folder, side, "chain-ckpt") for side in ("port", "jax"))
    timings["write_orbax"] = sh("write_orbax", [
        sys.executable, os.path.join(_REPO, "tools", "torch_convert_checkpoint.py"), pth, ours,
    ], workdir)
    here = os.path.dirname(os.path.abspath(__file__))
    timings["jax_resave"] = sh("jax_resave", [
        sys.executable, "-c", f"import sys; sys.path.insert(0, {here!r}); import "
        "torch_run_chain as c; c.jax_resave(*sys.argv[1:])", ours, theirs,
    ], workdir, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return same_target_encoder(pth, theirs)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default="/tmp/avjepa_torch_chain")
    ap.add_argument("--clips", type=int, default=100)
    ap.add_argument("--model", default="vit_tiny")
    ap.add_argument("--crop", type=int, default=64)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ipe", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--eval-epochs", type=int, default=300,
                    help="attentive-probe epochs of the frozen eval stages; they "
                    "run cache_features, so epochs after the one encode are "
                    "probe steps alone")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--clip-size", type=int, default=160,
                    help="generated clip frame w=h (transforms resize)")
    ap.add_argument("--pred-depth", type=int, default=None)
    ap.add_argument("--pred-embed", type=int, default=None)
    ap.add_argument("--reg-coeff", type=float, default=0.0,
                    help="variance-regulariser weight of the pretrain (the "
                    "reference ships 0.0)")
    ap.add_argument("--task", choices=["grating", "envelope"], default="envelope",
                    help="class-media family: 'envelope' (drift-balanced "
                    "second-order motion, which a random frozen encoder does "
                    "not decode) or 'grating' (first-order drift, which it "
                    "does)")
    ap.add_argument("--eval-shots", type=int, default=None,
                    help="if set, the frozen-probe stages train on only N clips "
                    "PER CLASS (a balanced prefix of the train CSV; val "
                    "unchanged)")
    ap.add_argument("--sticky", action="store_true",
                    help="set tpu.sticky_mask_buckets for the pretrain stage")
    ap.add_argument("--stages", default="all",
                    help="comma list of stages to run: "
                    "media,pretrain,roundtrip,eval,control,avpred,example,"
                    "extract (default all). Later stages assume earlier "
                    "ones' outputs exist in --workdir")
    ap.add_argument("--device", default="cuda",
                    help="device of every CLI (default cuda; cpu must be asked for)")
    ap.add_argument("--out-json", default=None,
                    help="also write the summary JSON to this path")
    ap.add_argument("--assert-learning", action="store_true",
                    help="fail unless pretrained val top-1 beats both "
                    "chance and the random-encoder control by >5 points")
    return ap.parse_args(argv)


def stage_configs(args: argparse.Namespace, wd: str, train_csv: str, val_csv: str,
                  probe_train_csv: str) -> dict:
    """Every CLI stage's config dict, by the name of its YAML: the JAX
    tool's, with the port's pretrain checkpoint (one ``.pth.tar``) where
    the JAX tool names its Orbax folder."""
    pred_depth = args.pred_depth or (12 if args.model == "vit_large" else 2)
    # 96 divides every backbone head count (the predictor keeps the
    # backbone's head count)
    pred_embed = args.pred_embed or (384 if args.model == "vit_large" else 96)
    pre_folder = os.path.join(wd, "pretrain")
    pretrain_cfg = {
        "app": "avjepa",
        "data": {
            "dataset_type": "audiovideodataset",
            "datasets": [train_csv],
            "batch_size": args.batch,
            "num_frames": args.frames,
            "tubelet_size": 2,
            "sampling_rate": 2,
            "crop_size": args.crop,
            "patch_size": 16,
            "num_workers": args.workers,
        },
        "mask": [
            {"aspect_ratio": [0.75, 1.5], "num_blocks": 8,
             "spatial_scale": [0.15, 0.15], "temporal_scale": [1.0, 1.0]},
            {"aspect_ratio": [0.75, 1.5], "num_blocks": 2,
             "spatial_scale": [0.7, 0.7], "temporal_scale": [1.0, 1.0]},
        ],
        "loss": {"loss_exp": 1.0, "reg_coeff": args.reg_coeff},
        "meta": {"seed": 0, "dtype": "bfloat16"},
        "model": {"model_name": args.model, "pred_depth": pred_depth,
                  "pred_embed_dim": pred_embed, "uniform_power": True,
                  "use_mask_tokens": True, "zero_init_mask_tokens": True},
        "optimization": {"ipe": args.ipe, "epochs": args.epochs, "warmup": 1},
        "logging": {"folder": pre_folder, "write_tag": "chain"},
        "tpu": {"remat": True, "attn_impl": "flash",
                "sticky_mask_buckets": bool(args.sticky)},
    }
    # the port's checkpoint: one reference-layout file, not an Orbax folder
    ckpt = os.path.join(pre_folder, "chain-latest.pth.tar")
    eval_folder = os.path.join(wd, "video_eval")
    eval_cfg = {
        "eval_name": "video_classification_frozen",
        "tag": "chain-eval",
        "data": {
            "dataset_train": probe_train_csv,
            "dataset_val": val_csv,
            "num_classes": 3,
            "frames_per_clip": args.frames,
            "num_segments": 2,
            "num_views_per_segment": 1,
            "frame_step": 2,
            "num_workers": args.workers,
        },
        "optimization": {
            "num_epochs": args.eval_epochs,
            "resolution": args.crop,
            "batch_size": args.batch,
            "attend_across_segments": True,
            "use_bfloat16": True,
            # frozen encoder: encode each train clip once, then probe steps
            # alone for every epoch
            "cache_features": True,
        },
        "pretrain": {
            "model_name": args.model,
            "patch_size": 16,
            "tubelet_size": 2,
            "uniform_power": True,
            "folder": pre_folder,
            "checkpoint": os.path.basename(ckpt),
        },
        "folder": eval_folder,
    }
    # the random-encoder control: the same probe on an untrained encoder
    # (the pretrained encoder's probe must beat it and chance for the chain
    # to show learning, not plumbing)
    ctrl_folder = os.path.join(wd, "video_eval_random")
    ctrl_cfg = dict(eval_cfg)
    ctrl_cfg["folder"] = ctrl_folder
    ctrl_cfg["tag"] = "chain-ctrl"
    ctrl_cfg["pretrain"] = dict(
        eval_cfg["pretrain"],
        folder=os.path.join(wd, "no_such_pretrain"),
        allow_missing_checkpoint=True,
    )
    ap_folder = os.path.join(wd, "avpred")
    ap_cfg = dict(pretrain_cfg)
    ap_cfg["app"] = "avprediction"
    ap_cfg["data"] = dict(pretrain_cfg["data"], batch_size=max(2, args.batch // 2))
    ap_cfg["meta"] = dict(pretrain_cfg["meta"], read_checkpoint=ckpt)
    ap_cfg["optimization"] = {"ipe": max(4, args.ipe // 4), "epochs": 1, "warmup": 1}
    ap_cfg["logging"] = {"folder": ap_folder, "write_tag": "chain"}
    x_folder = os.path.join(wd, "extract")
    x_cfg = {
        "app": "extract",
        "data": dict(pretrain_cfg["data"], datasets=[val_csv]),
        "meta": {"seed": 0, "dtype": "bfloat16", "read_checkpoint": ckpt},
        "model": pretrain_cfg["model"],
        "extract": {"pooling": "mean"},
        "logging": {"folder": x_folder, "write_tag": "chain"},
        "tpu": {"attn_impl": pretrain_cfg["tpu"]["attn_impl"]},
    }
    return {"pretrain": pretrain_cfg, "video_eval": eval_cfg, "video_eval_random": ctrl_cfg,
            "avpred": ap_cfg, "example": dict(ap_cfg, app="avprediction_example"),
            "extract": x_cfg}


def main(argv=None):
    args = parse_args(argv)
    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    py = sys.executable
    timings, summary = {}, {}
    all_stages = ["media", "pretrain", "roundtrip", "eval", "control",
                  "avpred", "example", "extract"]
    stages = set(all_stages) if args.stages == "all" else {
        s.strip() for s in args.stages.split(",")}
    unknown = stages - set(all_stages)
    assert not unknown, f"unknown stages {sorted(unknown)}"

    # -- 1. media (always: cheap, resumable, later stages need the CSVs) ---
    t0 = time.perf_counter()
    train_csv, val_csv = make_media(
        wd, args.clips, args.clip_size, args.clip_size,
        max(32, 2 * args.frames), task=args.task,
    )
    timings["media"] = time.perf_counter() - t0
    print(f"[chain] media: {args.clips} real AV clips, task={args.task} "
          f"({timings['media']:.1f}s)", flush=True)

    probe_train_csv = train_csv
    if args.eval_shots:
        # labels are interleaved i%3 in the CSV, so a 3N-line prefix is a
        # balanced N-per-class low-shot probe-train set
        with open(train_csv) as f:
            lines = f.readlines()
        assert len(lines) >= 3 * args.eval_shots, "not enough train clips"
        probe_train_csv = train_csv.replace(".csv", f"_{args.eval_shots}shot.csv")
        with open(probe_train_csv, "w") as f:
            f.writelines(lines[: 3 * args.eval_shots])
        summary["eval_shots"] = args.eval_shots

    cfgs = stage_configs(args, wd, train_csv, val_csv, probe_train_csv)
    paths = {}
    for name, cfg in cfgs.items():
        paths[name] = os.path.join(wd, f"{name}.yaml")
        with open(paths[name], "w") as f:
            yaml.safe_dump(cfg, f)

    def run(module: str, name: str) -> None:
        timings[name] = sh(name, [py, "-m", f"avjepa_tpu_torch.app.{module}", "--fname",
                                  paths[name], "--device", args.device], wd)

    # -- 2. pretrain -------------------------------------------------------
    pre_folder = cfgs["pretrain"]["logging"]["folder"]
    ckpt = cfgs["avpred"]["meta"]["read_checkpoint"]
    if "pretrain" in stages:
        run("main", "pretrain")
    pre_csv = os.path.join(pre_folder, "chain_r0.csv")
    if os.path.exists(pre_csv):
        summary["pretrain_loss"] = last_csv_value(pre_csv, "loss")

    # -- 3. the crossing: port -> JAX (Orbax) -> port, bit-exact ----------
    if "roundtrip" in stages:
        n = cross_checkpoint(ckpt, wd, timings)
        summary["roundtrip_leaves_exact"] = n
        print(f"[chain] roundtrip: {n} target-encoder entries bit-exact after "
              "port -> JAX -> port", flush=True)

    # -- 4. frozen video-classification eval on the pretrained ckpt --------
    if "eval" in stages:
        run("eval_main", "video_eval")
        summary["eval_train_acc"] = last_csv_value(
            os.path.join(cfgs["video_eval"]["folder"], "chain-eval_r0.csv"), "acc")

    def _val_top1(stage):
        log_path = os.path.join(wd, "logs", f"{stage}.log")
        if not os.path.exists(log_path):
            return None
        with open(log_path) as f:
            m = re.findall(r"val top-1: ([\d.]+)", f.read())
        return float(m[-1]) if m else None

    summary["eval_val_top1_pretrained"] = _val_top1("video_eval")
    summary["eval_val_top1"] = summary["eval_val_top1_pretrained"]

    # -- 4b. the random-encoder control ------------------------------------
    if "control" in stages:
        run("eval_main", "video_eval_random")
    summary["eval_val_top1_random_encoder"] = _val_top1("video_eval_random")

    # -- 5. avprediction probe on the frozen pretrained JEPA ---------------
    ap_folder = cfgs["avpred"]["logging"]["folder"]
    if "avpred" in stages:
        run("main", "avpred")
        summary["avpred_loss"] = last_csv_value(
            os.path.join(ap_folder, "chain_probe_r0.csv"), "loss")

    # -- 6. avprediction_example (reconstruction npz/PNG) -------------------
    if "example" in stages:
        run("main", "example")
        npz = os.path.join(ap_folder, "avprediction_example.npz")
        assert os.path.exists(npz), "example stage produced no npz"
        summary["example_npz"] = npz
        png = os.path.join(ap_folder, "avprediction_example.png")
        if os.path.exists(png):
            summary["example_png"] = png

    # -- 7. extract: serve the pretrained encoder (embeddings + index) -----
    if "extract" in stages:
        run("main", "extract")
        feats = np.load(os.path.join(cfgs["extract"]["logging"]["folder"], "chain-features",
                                     "features_r0.npz"))
        assert len(feats["indices"]) == len(set(feats["indices"].tolist()))
        summary["extract_rows"] = int(len(feats["indices"]))
        summary["extract_dim"] = int(feats["embeddings"].shape[1])

    summary["timings_s"] = {k: round(v, 1) for k, v in timings.items()}
    summary["model"] = args.model
    summary["clips"] = args.clips
    summary["task"] = args.task
    summary["device"] = args.device

    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"chain": summary}, f, indent=1)
    if args.assert_learning:
        pre = summary["eval_val_top1_pretrained"]
        ctl = summary["eval_val_top1_random_encoder"]
        chance = 100.0 / 3
        assert pre is not None and ctl is not None, summary
        assert pre > chance + 5.0, (
            f"pretrained probe {pre:.1f}% does not beat chance {chance:.1f}%")
        assert pre > ctl + 5.0, (
            f"pretrained probe {pre:.1f}% does not beat the random-encoder "
            f"control {ctl:.1f}%")
        print(f"[chain] learning gap OK: pretrained {pre:.1f}% > "
              f"control {ctl:.1f}% > chance {chance:.1f}%", flush=True)
    print(json.dumps({"chain": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
