"""Real-media ingest of the port (avjepa_tpu_torch.data) held against the JAX
package: the media writers, the batch loader with threads and with worker
processes over decoded files, retry-resample and the exact-validation
failure path, the apps' choice of processes, and the pretrain app on files.

Clips are tiny (8 frames of 32^2 with audio) and written by the port's
writers; each process pool has 2 workers. The workers inherit this
process's environment, BLAS thread count included: the mel's ``fb @ mag``
rounds its last bit differently under another OpenBLAS thread count, so a
worker limited to one thread would not match this process to the bit. The
JAX loader runs in thread mode, its cheaper reference (the JAX package's own
tests hold its process mode).
"""

import os
import pickle

import numpy as np
import pytest
import torch
import yaml

from torch_cpu import one_torch_thread  # noqa: F401 (autouse)
from avjepa_tpu.data import loader as jax_loader
from avjepa_tpu.data import video_decoder as jax_vd
from avjepa_tpu.data.av_dataset import AVFileDataset as JaxAVFileDataset
from avjepa_tpu.layout import TokenLayout as JaxTokenLayout
from avjepa_tpu.masks.multiblock3d import make_mask_collator as jax_make_mask_collator
from avjepa_tpu_torch.app.main import launch
from avjepa_tpu_torch.config import load_config
from avjepa_tpu_torch.data import video_decoder as vd
from avjepa_tpu_torch.data.av_dataset import AVFileDataset
from avjepa_tpu_torch.data.loader import (BatchLoader, FetchFailure, ShardedSampler, collate_av,
                                          exact_val_collate, fetch_with_retry)
from avjepa_tpu_torch.evals import av_prediction
from avjepa_tpu_torch.layout import TokenLayout
from avjepa_tpu_torch.masks.multiblock3d import make_mask_collator
from avjepa_tpu_torch.serve import extract
from avjepa_tpu_torch.train import pretrain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT_KW = dict(num_frames=4, crop_size=32, patch_size=16, tubelet_size=2)
DATA_KW = dict(frames_per_clip=4, frame_step=2, crop_size=32, random_resize_scale=(0.3, 1.0),
               reprob=0.25, seed=3)
MASKS = [{"aspect_ratio": [0.75, 1.5], "num_blocks": 2, "spatial_scale": [0.5, 0.5],
          "temporal_scale": [1.0, 1.0], "max_temporal_keep": 1.0}]
N_GOOD = 4


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Four clips by the port's writers (two each), labels 0-3, and a CSV
    with a corrupt fifth file."""
    d = tmp_path_factory.mktemp("ingest")
    rng = np.random.default_rng(0)
    paths = []
    for i in range(N_GOOD):
        paths.append(str(d / f"clip{i}.avi"))
        if i % 2:
            frames = rng.integers(0, 256, size=(8, 32, 32, 3), dtype=np.uint8)
            pcm = np.sin(np.arange(20000) * (0.01 + 0.01 * i)).astype(np.float32)
            vd.write_av_clip(paths[-1], frames, fps=25.0, pcm=pcm, sample_rate=44100)
        else:
            vd.write_test_video(paths[-1], n_frames=8, w=32, h=32, fps=25.0, with_audio=True)
    bad = d / "corrupt.avi"
    bad.write_bytes(rng.integers(0, 256, size=4096, dtype=np.uint8).tobytes())
    good_csv, bad_csv = d / "good.csv", d / "with_corrupt.csv"
    good_csv.write_text("".join(f"{p} {i}\n" for i, p in enumerate(paths)))
    bad_csv.write_text(good_csv.read_text() + f"{bad} 9\n")
    return {"dir": d, "good": str(good_csv), "bad": str(bad_csv)}


def test_writers_match_jax(media):
    """The port's writers give files that the JAX decoder reads as it reads
    the JAX writers' files: the same frames and PCM."""
    d, rng = media["dir"], np.random.default_rng(1)
    frames = rng.integers(0, 256, size=(6, 32, 48, 3), dtype=np.uint8)
    pcm = np.cos(np.arange(9000) * 0.02).astype(np.float32)
    pairs = []
    for name, write in (("test", lambda m, p: m.write_test_video(p, n_frames=6, w=48, h=32)),
                        ("clip", lambda m, p: m.write_av_clip(p, frames, pcm=pcm,
                                                              sample_rate=16000))):
        ours, theirs = str(d / f"ours_{name}.avi"), str(d / f"theirs_{name}.avi")
        write(vd, ours)
        write(jax_vd, theirs)
        pairs.append((ours, theirs))
    for ours, theirs in pairs:
        a, b = jax_vd.VideoFile(ours), jax_vd.VideoFile(theirs)
        assert (a.num_frames, a.width, a.height, a.fps) == (b.num_frames, b.width, b.height,
                                                             b.fps) == (6, 48, 32, 25.0)
        idx = np.arange(6)
        np.testing.assert_array_equal(a.decode_frames(idx), b.decode_frames(idx))
        pa, sra = a.decode_audio()
        pb, srb = b.decode_audio()
        assert sra == srb and len(pa) > 0
        np.testing.assert_array_equal(pa, pb)
    with pytest.raises(IOError):
        vd.write_av_clip(str(d / "nowhere" / "x.avi"), frames)


def _datasets(csv):
    return (AVFileDataset([csv], TokenLayout(**LAYOUT_KW), **DATA_KW),
            JaxAVFileDataset([csv], JaxTokenLayout(**LAYOUT_KW), **DATA_KW))


def _samplers(n, **kw):
    kw = dict(batch_size=2, shuffle=True, seed=5, num_shards=1, shard_index=0, **kw)
    return ShardedSampler(n, **kw), jax_loader.ShardedSampler(n, **kw)


@pytest.fixture(scope="module")
def process_loader(media):
    """One process loader (2 workers) over the CSV with the corrupt file."""
    ds, _ = _datasets(media["bad"])
    loader = BatchLoader(ds, _samplers(len(ds))[0], num_workers=2, use_processes=True,
                         mask_collator=make_mask_collator("multiblock3d", MASKS,
                                                          TokenLayout(**LAYOUT_KW), base_seed=2))
    yield loader
    pids = list(loader._pool._processes or {})
    loader.close()
    assert loader._pool._processes is None  # joined
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _batches(loader, epochs=(0, 1)):
    out = []
    for e in epochs:
        loader.set_epoch(e)
        out.extend(loader)
    return out


def _assert_batches_equal(got, want):
    assert len(got) == len(want) == 4  # 2 batches of 2 an epoch over 5 rows
    for g, w in zip(got, want):
        (gv, ga, gl, gm), (wv, wa, wl, wm) = g, w
        for a, b in ((gv, wv), (ga, wa), (gl, wl)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert len(gm) == len(wm)
        for ms, jms in zip(gm, wm):
            for f in ("enc", "pred", "enc_idx", "union_idx"):
                np.testing.assert_array_equal(getattr(ms, f), getattr(jms, f))


@pytest.mark.parametrize("processes", [False, True])
def test_batches_equal_jax_over_two_epochs(media, process_loader, processes):
    """Video, audio, labels and masks equal to the bit to the JAX loader's,
    epochs 0 and 1 (each its own crops), with threads and with processes.
    The corrupt row is drawn and resampled as JAX resamples it."""
    ds, jds = _datasets(media["bad"])
    sampler, jsampler = _samplers(len(ds))
    layout, jlayout = TokenLayout(**LAYOUT_KW), JaxTokenLayout(**LAYOUT_KW)
    jloader = jax_loader.JepaLoader(
        jds, jsampler, num_workers=2,
        mask_collator=jax_make_mask_collator("multiblock3d", MASKS, jlayout, base_seed=2))
    try:
        want = _batches(jloader)
    finally:
        jloader.close()
    if processes:
        loader = process_loader
        loader.mask_collator.set_counter(-1)
    else:
        loader = BatchLoader(ds, sampler, num_workers=2, mask_collator=make_mask_collator(
            "multiblock3d", MASKS, layout, base_seed=2))
    try:
        got = _batches(loader)
    finally:
        if not processes:
            loader.close()
    assert loader.stats["batches"] >= 4 and loader.stats["fetch_s"] > 0
    _assert_batches_equal(got, want)
    drawn = []
    for e in (0, 1):
        sampler.set_epoch(e)
        drawn += [list(rows) for rows in sampler]
    assert any(N_GOOD in rows for rows in drawn)  # the corrupt row was drawn


def test_corrupt_file_resamples_as_jax_and_fails_exactly(media, process_loader):
    """dataset[corrupt] resamples to the row JAX's _fetch_with_retry picks;
    under retry_resample=False the process loader hands a FetchFailure (it
    pickles) to exact_val_collate, which marks that row not ok."""
    ds, jds = _datasets(media["bad"])
    got, want = fetch_with_retry(ds, N_GOOD), jax_loader._fetch_with_retry(jds, N_GOOD)
    assert got[2] == want[2] != 9
    np.testing.assert_array_equal(got[0], want[0])
    f = pickle.loads(pickle.dumps(FetchFailure(N_GOOD)))
    assert isinstance(f, FetchFailure) and f.idx == N_GOOD

    loader = process_loader
    saved = loader.sampler, loader.collate, loader.mask_collator, loader.retry_resample
    loader.sampler = ShardedSampler(len(ds), 5, shuffle=False, drop_last=False)
    loader.collate, loader.mask_collator = exact_val_collate(collate_av), None
    loader.retry_resample = False
    try:
        (video, _, labels, ok), = list(loader)
    finally:
        loader.sampler, loader.collate, loader.mask_collator, loader.retry_resample = saved
    assert ok.tolist() == [True] * N_GOOD + [False]
    assert labels.tolist()[:N_GOOD] == list(range(N_GOOD)) and video.shape[0] == 5


def _pretrain_yaml(tmp_path, media, **data):
    with open(os.path.join(REPO, "configs/pretrain/av-vitt16.yaml")) as f:
        d = yaml.safe_load(f)
    d["data"].update({"source": "files", "datasets": [media["good"]], "crop_size": 32,
                      "num_frames": 4, "sampling_rate": 2, "batch_size": 2, "num_workers": 2,
                      **data})
    d["model"]["pred_depth"] = 2
    d["meta"]["dtype"] = "float32"
    d["optimization"].update(ipe=2, epochs=1)
    for m in d["mask"]:
        m["spatial_scale"] = [0.5, 0.5]
    d["logging"].update(folder=str(tmp_path), log_freq=1)
    path = os.path.join(tmp_path, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(d, f)
    return path, d


@pytest.mark.parametrize("source,num_workers", [("synthetic", 1), ("synthetic", 2),
                                                ("files", 1), ("files", 2)])
def test_apps_choose_processes_as_jax(tmp_path, media, source, num_workers):
    """pretrain (and the avprediction train app through it), extract and the
    av_prediction eval build a process loader exactly where the JAX
    expression ``source != "synthetic" and num_workers > 1`` is true. No pool
    starts a worker before it is iterated."""
    _, d = _pretrain_yaml(tmp_path, media, source=source, num_workers=num_workers)
    cfg = load_config(d)
    want = source != "synthetic" and num_workers > 1
    handles = pretrain.setup(cfg, torch.device("cpu"))
    ds, _, _ = extract._build_dataset(cfg, cfg.layout())
    loaders = [handles.loader, extract.build_loader(cfg, extract._IndexedView(ds)),
               av_prediction.build_eval_loader(cfg, cfg.layout())]
    for loader in loaders:
        assert loader.use_processes is want
        loader.close()


def test_pretrain_cli_on_files_with_processes_equals_one_worker(tmp_path, media):
    """Two steps through the CLI on the CPU on decoded files: the process
    loader's run ends with the one-worker (thread) run's mean loss and
    weights, to the bit, and logs its losses."""
    runs = {}
    for nw in (2, 1):
        folder = tmp_path / f"w{nw}"
        folder.mkdir()
        path, d = _pretrain_yaml(folder, media, num_workers=nw)
        summary = launch(path, device="cpu")
        tag = d["logging"]["write_tag"]
        rows = open(folder / f"{tag}_r0.csv").read().splitlines()[1:]
        saved = torch.load(folder / f"{tag}-latest.pth.tar", map_location="cpu",
                           weights_only=True)
        runs[nw] = (summary["avg_loss"], [r.split(",")[2] for r in rows], saved)
    (loss2, rows2, ckpt2), (loss1, rows1, ckpt1) = runs[2], runs[1]
    assert len(rows2) == 2 and rows2 == rows1 and np.isfinite(loss2) and loss2 == loss1
    assert ckpt2["step"] == 2
    for model in ("encoder", "predictor", "target_encoder"):
        for k, v in ckpt2[model].items():
            assert torch.equal(v, ckpt1[model][k]), (model, k)
