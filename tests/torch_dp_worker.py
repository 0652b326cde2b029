"""One rank of the port's data-parallel tests (tests/test_torch_parallel.py).

    python tests/torch_dp_worker.py <rank> <world> <port> <outdir> <mode>...

Each rank is its own process with its own torch runtime, joined to the
others by ``parallel.dist.init_distributed`` over gloo on the CPU (the
stand-in for one process per GPU over NCCL), and runs the modes in order,
writing ``result_<mode>_<rank>.json`` (and the step mode's gradients) into
``outdir``:
  - ``step``: the step inputs ``step_<case>.npz`` and weights
    ``weights.pt`` written by the test; each rank takes its half of every
    global batch and runs three ``train_step``s, recording losses, the
    gradient all-reduces per step and a digest of its weights; rank 0
    writes the first step's gradients and the last step's weights;
  - ``fsdp_step``: the same under ``mesh_fsdp: 2`` (the models sharded over
    the two ranks), recording which parameters are sharded;
  - ``hsdp_step``: the same on four ranks, a 2 x 2 (data, fsdp) mesh;
  - ``tp_step``: the ``unequal`` case under ``mesh_tensor: 2`` (both ranks
    on the whole global batch, the Megatron layers cut over them), the
    mesh's rank layout, and a tiny encoder whose 4 heads are cut too (its
    loss and gradients against the unsharded encoder in the same process);
  - ``tp_fsdp_step``: the ``unequal`` case on four ranks, fsdp 2 x tensor 2;
  - ``info``: the collator's masks at the local batch (same seed on every
    rank) and the sampler's shard;
  - ``pretrain``: the pretrain app for 2 steps (a copy of its checkpoint
    kept as ``step2.pth.tar``), then resumed for 2;
  - ``fsdp_pretrain``: the pretrain app under ``mesh_fsdp: 2`` for 2 steps,
    then resumed from ``pretrain``'s ``step2.pth.tar`` for 1;
  - ``fsdp_vjepa``: the vjepa app under ``mesh_fsdp: 2`` for 2 steps;
  - ``preempt``: SIGTERM to rank 1 only, mid-run (the video-only app: 8
    tokens, the cheapest steps);
  - ``eval``: the video eval and the image eval, each validation only,
    then 2 probe steps;
  - ``extract``: the extract app over 11 rows;
  - ``avprediction``: 2 probe steps on ``pretrain``'s checkpoint, the
    example, and the av_prediction eval;
  - ``fsdp_avprediction``: the probe steps and the eval under
    ``mesh_fsdp: 2`` (the frozen models sharded);
  - ``tp_pretrain``: the pretrain app under ``mesh_tensor: 2`` for 2 steps,
    then resumed from ``pretrain``'s ``step2.pth.tar`` for 1;
  - ``tp_avprediction``: 2 probe steps under ``mesh_tensor: 2``.
No JAX is imported here.
"""

import hashlib
import json
import os
import shutil
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the step test's models: test_torch_train.py's (crop 64, 4 frames, audio:
# 128 tokens; encoder 2 x 192, 3 heads of 64; predictor 2 x 384, 3 of 128)
LAYOUT = dict(num_frames=4, crop_size=64, patch_size=16, tubelet_size=2)
ENC = dict(embed_dim=192, depth=2, num_heads=3, uniform_power=True, attn_impl="flash",
           gelu="tanh")
PRED = dict(embed_dim=192, predictor_embed_dim=384, depth=2, num_heads=3,
            uniform_power=True, num_mask_tokens=2, attn_impl="flash", gelu="tanh")
SCHED = dict(ipe=10, num_epochs=4, warmup_epochs=1)
STEP = dict(loss_exp=1.0, reg_coeff=0.5, clip_grad=10.0, warmup_epochs=1, ipe=10)
CASES = ("equal", "unequal")


def pretrain_cfg(folder: str, **over) -> dict:
    """configs/pretrain/av-vitt16.yaml cut as tests/test_torch_train.py::_yaml
    cuts it (synthetic, crop 32, 4 frames, batch 2 a rank, predictor depth
    2, one epoch of 2 steps), in f32 and without remat (the same numbers,
    less time on a loaded CPU), logging into ``folder``; ``over`` updates
    sections."""
    import yaml

    with open(os.path.join(REPO, "configs/pretrain/av-vitt16.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], crop_size=32, num_frames=4, batch_size=2,
                     num_workers=2)
    d["model"]["pred_depth"] = 2
    d["meta"]["dtype"] = "float32"
    d["tpu"]["remat"] = False
    d["optimization"].update(ipe=2, epochs=1)
    for m in d["mask"]:
        m["spatial_scale"] = [0.5, 0.5]  # blocks that do not round to 0 on a 2x2 grid
    d["logging"].update(folder=folder, log_freq=1)
    for section, values in over.items():
        d[section].update(values)
    return d


def eval_cfg(folder: str, tag: str, **opt):
    """The tiny synthetic video eval (vit_tiny, crop 32, 4 frames, 5
    classes, 2 segments x 2 views attended across) of
    tests/test_torch_evals.py, at 2 clips a rank."""
    from avjepa_tpu_torch.evals import video_classification as vc

    return vc.config_from_yaml({
        "folder": folder, "tag": tag,
        "data": {"source": "synthetic", "num_classes": 5, "num_workers": 2,
                 "frames_per_clip": 4, "num_segments": 2, "num_views_per_segment": 2,
                 "frame_step": 2},
        "optimization": {"batch_size": 2, "resolution": 32, "use_bfloat16": False, **opt},
        "pretrain": {"model_name": "vit_tiny", "frames_per_clip": 4, "checkpoint": ""},
    })


def image_eval_cfg(folder: str, tag: str, **opt):
    """The image eval's counterpart of ``eval_cfg``."""
    from avjepa_tpu_torch.evals import image_classification as ic

    return ic.config_from_yaml({
        "folder": folder, "tag": tag, "data": {"source": "synthetic", "num_classes": 5,
                                               "num_workers": 2},
        "optimization": {"batch_size": 2, "resolution": 32, "use_bfloat16": False, **opt},
        "pretrain": {"model_name": "vit_tiny", "frames_per_clip": 4, "checkpoint": ""},
    })


def prediction_cfg(folder: str, ckpt: str) -> dict:
    """configs/pretrain/av-vitt16_prediction.yaml cut as
    tests/test_torch_avprediction.py::_cfg cuts it, reading ``ckpt``."""
    import yaml

    with open(os.path.join(REPO, "configs/pretrain/av-vitt16_prediction.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update(source="synthetic", datasets=[], crop_size=32, num_frames=4, batch_size=2,
                     num_workers=2)
    d["meta"].update(dtype="float32", read_checkpoint=ckpt)
    d["model"]["pred_depth"] = 2
    d["optimization"].update(ipe=2, epochs=1)
    for m in d["mask"]:
        m["spatial_scale"] = [0.5, 0.5]
    d["logging"].update(folder=folder, log_freq=1)
    return d


def pretrain_checkpoint(outdir: str) -> str:
    """The checkpoint the ``pretrain`` mode leaves."""
    d = pretrain_cfg(os.path.join(outdir, "pretrain"))
    return os.path.join(d["logging"]["folder"], f"{d['logging']['write_tag']}-latest.pth.tar")


def extract_cfg(folder: str) -> dict:
    return {
        "app": "extract", "meta": {"seed": 3, "dtype": "float32"},
        "data": {"source": "synthetic", "dataset_type": "audiovideodataset", "batch_size": 2,
                 "num_frames": 4, "tubelet_size": 2, "crop_size": 32, "patch_size": 16,
                 "num_workers": 1},
        "model": {"model_name": "vit_tiny"},
        # 11 rows, odd on purpose: the shard padding puts a copy of row 0 in
        # rank 1's shard, which must not write it
        "extract": {"pooling": "mean", "allow_random": True, "limit": 11,
                    "output": os.path.join(folder, "features")},
        "logging": {"folder": os.path.join(folder, "logs"), "write_tag": "x"},
    }


def read_losses(path: str) -> list:
    import csv

    with open(path) as f:
        return [float(r["loss"]) for r in csv.DictReader(f) if r["epoch"] != "epoch"]


def whole(t, split=None):
    """``t`` whole on the host of every rank: gathered over the fsdp shards
    and joined over the tensor group where ``split`` cuts it."""
    from avjepa_tpu_torch.parallel import fsdp, tensor

    if split is None:
        return fsdp.full_tensor(t)
    return tensor.gather(fsdp.full_tensor(t) if fsdp.is_sharded(t) else t.detach(), split)


def digest(modules) -> str:
    """A hash of the modules' whole weights (gathered where sharded)."""
    from avjepa_tpu_torch.parallel import tensor

    h = hashlib.sha256()
    for m in modules:
        splits = tensor.splits(m)
        for k, v in m.state_dict().items():
            h.update(whole(v, splits.get(k)).contiguous().numpy().tobytes())
    return h.hexdigest()


def sharding(modules: dict) -> dict:
    """Each module's parameters: name -> (global shape, this rank's shard's
    shape, or None where the parameter is not sharded, the shape of this
    rank's tensor piece, or None where the tensor axis does not cut it)."""
    from avjepa_tpu_torch.parallel import fsdp, tensor

    out = {}
    for name, m in modules.items():
        splits = tensor.splits(m)
        out[name] = {k: [list(p.shape), list(fsdp.local(p).shape) if fsdp.is_sharded(p) else None,
                         list(p.shape) if k in splits else None]
                     for k, p in m.named_parameters()}
    return out


def local_half(inputs: dict, rank: int, world: int) -> dict:
    """This rank's rows of a global step batch (``step_inputs``'s layout)."""
    import torch

    b = inputs["video"].shape[0] // world
    lo, hi = rank * b, (rank + 1) * b
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(video=t(inputs["video"][lo:hi]), audio=t(inputs["audio"][lo:hi]),
                enc_masks=t(inputs["enc"][:, lo:hi]), pred_masks=t(inputs["pred"][:, lo:hi]),
                enc_idx=tuple(t(inputs[f"idx{i}"][lo:hi]) for i in range(inputs["enc"].shape[0])),
                union_idx=t(inputs["union"][:, lo:hi]))


def build_state(weights: dict, mesh=None):
    from avjepa_tpu_torch.layout import TokenLayout
    from avjepa_tpu_torch.models.encoder import Encoder
    from avjepa_tpu_torch.models.predictor import Predictor
    from avjepa_tpu_torch.train.state import init_state

    layout = TokenLayout(**LAYOUT)
    encoder, predictor = Encoder(layout, **ENC), Predictor(layout, **PRED)
    encoder.load_state_dict(weights["encoder"])
    predictor.load_state_dict(weights["predictor"])
    return init_state(encoder, predictor, mesh=mesh)


def run_steps(rank: int, world: int, outdir: str, prefix: str = "", data: int = -1,
              fsdp_: int = 1, cases=CASES, tensor_: int = 1) -> dict:
    """Three ``train_step``s of each case on this rank's rows, on a
    ``data`` x ``fsdp_`` x ``tensor_`` mesh; rank 0 writes
    ``<prefix>grads_<case>.npz`` (the first step's gradients, whole) and
    ``<prefix>weights_<case>.npz`` (the three models' weights after the last
    step)."""
    import torch

    from avjepa_tpu_torch.parallel import dist, fsdp, tensor
    from avjepa_tpu_torch.train import optim
    from avjepa_tpu_torch.train.step import StepConfig, train_step

    mesh = dist.make_mesh(data, fsdp_, tensor_, "cpu")
    out = {}
    for case in cases:
        state = build_state(torch.load(os.path.join(outdir, "weights.pt")), mesh)
        models = {"encoder": state.encoder, "predictor": state.predictor,
                  "target_encoder": state.target_encoder}
        z = np.load(os.path.join(outdir, f"step_{case}.npz"))
        losses, reductions, shards, digests, counts, tensor_counts = [], [], [], [], [], []
        for i in range(z["video"].shape[0]):
            inputs = local_half({k: z[k][i] for k in z.files}, mesh.batch_rank, mesh.batch)
            counts.append(inputs["pred_masks"].flatten(1).sum(1).tolist())
            before = dict(dist.REDUCTIONS)
            m = train_step(state, optim.ScheduleConfig(**SCHED), StepConfig(**STEP), **inputs)
            reductions.append(dist.REDUCTIONS["grads"] - before.get("grads", 0))
            shards.append(dist.REDUCTIONS["shards"] - before.get("shards", 0))
            tensor_counts.append([dist.REDUCTIONS[k] - before.get(k, 0)
                                  for k in ("tensor", "tensor_shards")])
            losses.append(m["loss"])
            digests.append(digest(models.values()))
            if i == 0:
                out[f"{case}_first"] = {k: m[k] for k in ("loss", "enc_grad_norm",
                                                          "pred_grad_norm", "enc_grad_avg",
                                                          "pred_grad_avg", "opt_mu_abs")}
                grads = {f"{name}/{k}": whole(p.grad, tensor.splits(models[name]).get(k)).numpy()
                         for name in ("encoder", "predictor")
                         for k, p in models[name].named_parameters()}
                if rank == 0:
                    np.savez(os.path.join(outdir, f"{prefix}grads_{case}.npz"), **grads)
        weights = {f"{name}/{k}": v.numpy() for name, mod in models.items()
                   for k, v in fsdp.full_state_dict(mod).items()}  # {} but on rank 0
        if rank == 0:
            np.savez(os.path.join(outdir, f"{prefix}weights_{case}.npz"), **weights)
        out[case] = {"losses": losses, "reductions": reductions, "shard_reductions": shards,
                     "tensor_reductions": tensor_counts, "digests": digests,
                     "pred_counts": counts, "sharding": sharding(models)}
    out["mesh"] = {"batch": mesh.batch, "batch_rank": mesh.batch_rank,
                   "tensor_index": None if mesh.tensor_group is None else mesh.tensor_group.index,
                   "batch_index": None if mesh.batch_group is None else mesh.batch_group.index}
    return out


def run_step(rank: int, world: int, outdir: str) -> dict:
    return run_steps(rank, world, outdir)


def run_fsdp_step(rank: int, world: int, outdir: str) -> dict:
    return run_steps(rank, world, outdir, "fsdp_", data=1, fsdp_=2)


def run_hsdp_step(rank: int, world: int, outdir: str) -> dict:
    return run_steps(rank, world, outdir, "hsdp_", data=2, fsdp_=2, cases=("unequal",))


def run_tp_step(rank: int, world: int, outdir: str) -> dict:
    out = run_steps(rank, world, outdir, "tp_", data=1, cases=("unequal",), tensor_=2)
    out["block"] = tensor_block(rank)
    return out


def run_tp_fsdp_step(rank: int, world: int, outdir: str) -> dict:
    return run_steps(rank, world, outdir, "tp_fsdp_", data=1, fsdp_=2, cases=("unequal",),
                     tensor_=2)


def tensor_block(rank: int) -> dict:
    """A tiny encoder (2 x 128, 4 heads of 32: the packed path, whose 2
    local heads take it too) with remat, cut over this two-rank tensor
    group, against the same encoder unsharded in this process: the output
    and every parameter's whole gradient (max abs difference), and the
    packed forward's calls (the plain version's) in the sharded backward."""
    import torch

    from avjepa_tpu_torch.layout import TokenLayout
    from avjepa_tpu_torch.models.encoder import Encoder
    from avjepa_tpu_torch.models.factory import init_encoder_params
    from avjepa_tpu_torch.ops import flash_attention as fa
    from avjepa_tpu_torch.parallel import dist, tensor

    layout = TokenLayout(num_frames=4, crop_size=32, patch_size=16, tubelet_size=2)
    kw = dict(embed_dim=128, depth=2, num_heads=4, attn_impl="flash", gelu="tanh", remat=True)
    plain, cut = Encoder(layout, **kw), Encoder(layout, **kw)
    init_encoder_params(plain, 5)
    cut.load_state_dict(plain.state_dict())
    mesh = dist.make_mesh(1, 1, 2, "cpu")
    tensor.shard_models(mesh.tensor_group, cut)
    gen = torch.Generator().manual_seed(6)
    video = torch.randn(2, 4, 32, 32, 3, generator=gen)
    audio = torch.randn(2, 128, 192, 1, generator=gen)
    key_mask = torch.rand(2, layout.num_tokens, generator=gen) < 0.8
    probe = torch.randn(2, layout.num_tokens, 128, generator=gen)
    outs = []
    for enc in (plain, cut):
        y = enc(video, audio, key_mask=key_mask)
        (y.float() * probe).mean().backward()
        outs.append(y.detach())
    splits = tensor.splits(cut)
    grads = {k: (whole(p.grad, splits.get(k)) - dict(plain.named_parameters())[k].grad)
             .abs().max().item() for k, p in cut.named_parameters()}
    calls = {"n": 0}
    ref = fa.flash_attention_qkv_ref

    def counted(*a, **k):
        calls["n"] += 1
        return ref(*a, **k)

    fa.flash_attention_qkv_ref = counted
    try:
        (cut(video, audio, key_mask=key_mask).float() * probe).mean().backward()
    finally:
        fa.flash_attention_qkv_ref = ref
    return {"out_err": (outs[0] - outs[1]).abs().max().item(),
            "out_max": outs[0].abs().max().item(), "grad_err": grads,
            "grad_max": {k: p.grad.abs().max().item() for k, p in plain.named_parameters()},
            "cut": sorted(splits), "local_qkv": list(cut.blocks[0].attn.qkv.weight.shape),
            "packed_calls": calls["n"]}


def run_info(rank: int, world: int, outdir: str) -> dict:
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.data.loader import ShardedSampler
    from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator

    cfg = load_config(pretrain_cfg(outdir))
    collator = make_mask_collator("multiblock3d", cfg.mask, cfg.layout(), base_seed=123)
    h = hashlib.sha256()
    sizes = []
    for _ in range(3):
        draw = collator(cfg.data.batch_size)
        for m in draw:
            for a in (m.enc, m.pred, m.enc_idx, m.union_idx):
                h.update(np.ascontiguousarray(a).tobytes())
        sizes.append([[m.pred.sum(1).tolist(), m.enc.sum(1).tolist(), m.enc_idx.shape[1],
                       m.union_idx.shape[1]] for m in draw])
    sampler = ShardedSampler(32, 2, seed=5, num_shards=world, shard_index=rank)
    sampler.set_epoch(1)
    return {"collator_sha": h.hexdigest(), "block_sizes": sizes,
            "sampler_indices": [int(i) for batch in sampler for i in batch]}


def run_pretrain(rank: int, world: int, outdir: str) -> dict:
    import torch

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain

    folder = os.path.join(outdir, "pretrain")
    d = pretrain_cfg(folder, data={"log_resource_utilization": True})
    tag = d["logging"]["write_tag"]
    csv = os.path.join(folder, f"{tag}_r{rank}.csv")
    pretrain.run(load_config(d), device="cpu")
    losses = read_losses(csv)
    latest = os.path.join(folder, f"{tag}-latest.pth.tar")
    saved = torch.load(latest, weights_only=True)
    if rank == 0:
        shutil.copy(latest, os.path.join(folder, "step2.pth.tar"))
    os.replace(csv, csv + ".phase1")
    d = pretrain_cfg(folder, optimization={"epochs": 2}, meta={"load_checkpoint": True})
    summary = pretrain.run(load_config(d), device="cpu")
    return {"losses": losses, "resume_losses": read_losses(csv), "summary": summary,
            "saved_step": saved["step"], "saved_world_size": saved["world_size"],
            "resources": os.path.exists(os.path.join(folder, f"{tag}_resources_r{rank}.csv"))}


def run_preempt(rank: int, world: int, outdir: str) -> dict:
    """SIGTERM to rank 1 only, once its CSV holds 3 rows; both ranks must
    stop at the same step and checkpoint there."""
    import signal
    import threading
    import time

    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain

    folder = os.path.join(outdir, "preempt")
    d = pretrain_cfg(folder, optimization={"ipe": 20, "epochs": 3},
                     data={"dataset_type": "videodataset"})
    d["app"] = "vjepa"
    csv = os.path.join(folder, f"{d['logging']['write_tag']}_r{rank}.csv")
    if rank == 1:
        def signal_after_rows(n: int = 3):
            while True:
                try:
                    with open(csv) as f:
                        if sum(1 for _ in f) > n:  # the header and n rows
                            break
                except OSError:
                    pass
                time.sleep(0.05)
            os.kill(os.getpid(), signal.SIGTERM)

        threading.Thread(target=signal_after_rows, daemon=True).start()
    summary = pretrain.run(load_config(d), device="cpu")
    return {"preempted": bool(summary.get("preempted")), "step": summary.get("step"),
            "losses": read_losses(csv)}


def run_eval(rank: int, world: int, outdir: str) -> dict:
    import dataclasses

    from avjepa_tpu_torch.evals import image_classification as ic
    from avjepa_tpu_torch.evals import video_classification as vc

    out = {}
    for name, module, make in (("video", vc, eval_cfg), ("image", ic, image_eval_cfg)):
        cfg = make(os.path.join(outdir, "eval"), f"{name}-val", num_epochs=0)
        val_only = module.run(cfg, device="cpu")
        trained = module.run(dataclasses.replace(cfg, num_epochs=1, tag=f"{name}-train"),
                             max_steps=2, device="cpu")
        out[name] = {"val_top1_untrained": val_only["val_top1"],
                     "val_top1_trained": trained["val_top1"],
                     "train_losses": read_losses(os.path.join(cfg.folder,
                                                              f"{name}-train_r{rank}.csv"))}
    return out


def run_extract(rank: int, world: int, outdir: str) -> dict:
    from avjepa_tpu_torch.registry import app_main

    return app_main("extract", extract_cfg(outdir), device="cpu")


def run_avprediction(rank: int, world: int, outdir: str) -> dict:
    from avjepa_tpu_torch.evals import av_prediction
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import avprediction

    d = prediction_cfg(os.path.join(outdir, "avprediction"), pretrain_checkpoint(outdir))
    avprediction.run(load_config(d), device="cpu")
    example = avprediction.example_main(d, device="cpu")
    summary = av_prediction.run(load_config(d), max_batches=4, device="cpu")
    tag = d["logging"]["write_tag"]
    return {"losses": read_losses(os.path.join(d["logging"]["folder"], f"{tag}_probe_r{rank}.csv")),
            "example": example, "eval": summary}


def run_fsdp_pretrain(rank: int, world: int, outdir: str) -> dict:
    """``pretrain``'s first run under ``mesh_fsdp: 2``, then ``pretrain``'s
    step-2 checkpoint (written at ``mesh_data: 2``) resumed under it for one
    step."""
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain

    folder = os.path.join(outdir, "pretrain-fsdp")
    d = pretrain_cfg(folder, tpu={"mesh_fsdp": 2})
    tag = d["logging"]["write_tag"]
    csv = os.path.join(folder, f"{tag}_r{rank}.csv")
    pretrain.run(load_config(d), device="cpu")
    losses = read_losses(csv)
    resume = os.path.join(outdir, "pretrain-fsdp-resume")
    if rank == 0:
        os.makedirs(resume, exist_ok=True)
        shutil.copy(os.path.join(outdir, "pretrain", "step2.pth.tar"),
                    os.path.join(resume, f"{tag}-latest.pth.tar"))
    d = pretrain_cfg(resume, tpu={"mesh_fsdp": 2}, optimization={"epochs": 2},
                     meta={"load_checkpoint": True})
    summary = pretrain.run(load_config(d), max_steps=1, device="cpu")
    return {"losses": losses, "resume_losses": read_losses(os.path.join(resume,
                                                                        f"{tag}_r{rank}.csv")),
            "summary": summary}


def fsdp_vjepa_cfg(folder: str) -> dict:
    d = pretrain_cfg(folder, data={"dataset_type": "videodataset"}, tpu={"mesh_fsdp": 2})
    d["app"] = "vjepa"
    return d


def run_fsdp_vjepa(rank: int, world: int, outdir: str) -> dict:
    from avjepa_tpu_torch.registry import app_main

    d = fsdp_vjepa_cfg(os.path.join(outdir, "vjepa-fsdp"))
    summary = app_main("vjepa", d, device="cpu")
    return {"losses": read_losses(os.path.join(d["logging"]["folder"],
                                               f"{d['logging']['write_tag']}_r{rank}.csv")),
            "summary": summary}


def run_fsdp_avprediction(rank: int, world: int, outdir: str) -> dict:
    """``avprediction``'s probe steps and eval under ``mesh_fsdp: 2``, and
    which parameters of the frozen models are sharded."""
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.evals import av_prediction
    from avjepa_tpu_torch.train import avprediction

    d = prediction_cfg(os.path.join(outdir, "avprediction-fsdp"), pretrain_checkpoint(outdir))
    d["tpu"]["mesh_fsdp"] = 2
    avprediction.run(load_config(d), device="cpu")
    summary = av_prediction.run(load_config(d), max_batches=4, device="cpu")
    handles, state, _ = avprediction.setup_probe(load_config(d), "cpu")
    handles.loader.close()
    tag = d["logging"]["write_tag"]
    return {"losses": read_losses(os.path.join(d["logging"]["folder"], f"{tag}_probe_r{rank}.csv")),
            "eval": summary,
            "sharding": sharding({"target_encoder": handles.state.target_encoder,
                                  "predictor": handles.state.predictor, "probe": state.probe})}


def run_tp_pretrain(rank: int, world: int, outdir: str) -> dict:
    """``pretrain``'s first run under ``mesh_tensor: 2`` (both ranks load
    the same batch of 2), then ``pretrain``'s step-2 checkpoint (written at
    ``mesh_data: 2``) resumed under it for one step."""
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import pretrain

    folder = os.path.join(outdir, "pretrain-tp")
    d = pretrain_cfg(folder, tpu={"mesh_tensor": 2})
    tag = d["logging"]["write_tag"]
    pretrain.run(load_config(d), device="cpu")
    losses = read_losses(os.path.join(folder, f"{tag}_r{rank}.csv"))
    resume = os.path.join(outdir, "pretrain-tp-resume")
    if rank == 0:
        os.makedirs(resume, exist_ok=True)
        shutil.copy(os.path.join(outdir, "pretrain", "step2.pth.tar"),
                    os.path.join(resume, f"{tag}-latest.pth.tar"))
    d = pretrain_cfg(resume, tpu={"mesh_tensor": 2}, optimization={"epochs": 2},
                     meta={"load_checkpoint": True})
    summary = pretrain.run(load_config(d), max_steps=1, device="cpu")
    return {"losses": losses, "summary": summary,
            "resume_losses": read_losses(os.path.join(resume, f"{tag}_r{rank}.csv"))}


def run_tp_avprediction(rank: int, world: int, outdir: str) -> dict:
    """``avprediction``'s probe steps under ``mesh_tensor: 2`` (the frozen
    models cut, the probe replicated), on ``pretrain``'s checkpoint."""
    from avjepa_tpu_torch.config import load_config
    from avjepa_tpu_torch.train import avprediction

    d = prediction_cfg(os.path.join(outdir, "avprediction-tp"), pretrain_checkpoint(outdir))
    d["tpu"]["mesh_tensor"] = 2
    avprediction.run(load_config(d), device="cpu")
    tag = d["logging"]["write_tag"]
    return {"losses": read_losses(os.path.join(d["logging"]["folder"], f"{tag}_probe_r{rank}.csv"))}


MODES = {"step": run_step, "info": run_info, "pretrain": run_pretrain,
         "preempt": run_preempt, "eval": run_eval, "extract": run_extract,
         "avprediction": run_avprediction, "fsdp_step": run_fsdp_step,
         "hsdp_step": run_hsdp_step, "fsdp_pretrain": run_fsdp_pretrain,
         "fsdp_vjepa": run_fsdp_vjepa, "fsdp_avprediction": run_fsdp_avprediction,
         "tp_step": run_tp_step, "tp_fsdp_step": run_tp_fsdp_step,
         "tp_pretrain": run_tp_pretrain, "tp_avprediction": run_tp_avprediction}


def main():
    import faulthandler

    # a hang shows where, before the test's join limit kills the rank
    faulthandler.dump_traceback_later(110, exit=True)
    rank, world, port, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
    import torch

    from avjepa_tpu_torch.parallel import dist

    torch.set_num_threads(1)  # the test workers share the cores; see the test's _env
    dist.init_distributed("cpu", timeout_s=60)
    try:
        for mode in sys.argv[5:]:
            result = {"rank": rank, "world": dist.world(), **MODES[mode](rank, world, outdir)}
            with open(os.path.join(outdir, f"result_{mode}_{rank}.json"), "w") as f:
                json.dump(result, f, default=str)
    finally:
        dist.shutdown()
    print("WORKER_DONE", flush=True)


if __name__ == "__main__":
    main()
