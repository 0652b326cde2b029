"""File-backed AV / video datasets (CSV-indexed .mp4 et al.); the port's copy
of ``avjepa_tpu/data/av_dataset.py``.

Behavioral parity with the reference datasets
(reference: src/datasets/audiovideo_dataset.py, video_dataset.py):

- index: space-delimited ``path label`` CSV rows, or a .npy array of rows;
  multiple CSVs concatenate, with optional per-dataset weights for the
  weighted sampler.
- clip sampling: partition the video into ``num_clips`` equal segments; in
  each, sample a random (or uniform) window of ``frames_per_clip*frame_step``
  frames; linspace fpc indices inside it; edge-pad short videos
  (reference: audiovideo_dataset.py:246-296).
- audio: decode the PCM span aligned to the sampled frame range, mel-spec to
  [128, 192] (reference: :302-349).
- decode failures raise; the loader's retry-resample loop handles them
  (reference resamples a random index, :163-170).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from avjepa_tpu_torch.data.mel import mel_spectrogram
from avjepa_tpu_torch.data.transforms import VideoTransform
from avjepa_tpu_torch.data.video_decoder import VideoFile
from avjepa_tpu_torch.layout import TokenLayout


def load_index(csv_paths: Sequence[str]) -> tuple[list[str], np.ndarray, np.ndarray]:
    """Returns (paths, labels, dataset_ids)."""
    paths: list[str] = []
    labels: list[int] = []
    ds_ids: list[int] = []
    for di, p in enumerate(csv_paths):
        if p.endswith(".npy"):
            rows = np.load(p, allow_pickle=True)
            for row in rows:
                parts = str(row).rsplit(" ", 1)
                # same fallback as the CSV branch: a row whose path contains
                # spaces and has no trailing numeric label is all-path
                try:
                    labels.append(int(float(parts[1])))
                    paths.append(parts[0])
                except (IndexError, ValueError):
                    labels.append(0)
                    paths.append(str(row))
                ds_ids.append(di)
        else:
            with open(p) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.rsplit(" ", 1)
                    paths.append(parts[0])
                    try:
                        labels.append(int(float(parts[1])))
                    except (IndexError, ValueError):
                        labels.append(0)
                        parts = [line]
                    if len(parts) == 1:
                        paths[-1] = line
                    ds_ids.append(di)
    return paths, np.asarray(labels), np.asarray(ds_ids)


def sample_clip_indices(
    total_frames: int,
    frames_per_clip: int,
    frame_step: int,
    num_clips: int,
    rng: np.random.Generator,
    random_clip_sampling: bool = True,
    allow_clip_overlap: bool = False,
) -> list[np.ndarray]:
    """Reference partition/window/linspace/edge-pad logic."""
    fpc = frames_per_clip
    clip_len = int(fpc * frame_step)
    partition_len = total_frames // num_clips
    clips = []
    for i in range(num_clips):
        if partition_len > clip_len:
            end_indx = clip_len
            if random_clip_sampling:
                end_indx = int(rng.integers(clip_len, partition_len))
            start_indx = end_indx - clip_len
            indices = np.linspace(start_indx, end_indx, num=fpc)
            indices = np.clip(indices, start_indx, end_indx - 1).astype(np.int64)
            indices = indices + i * partition_len
        else:
            if not allow_clip_overlap:
                npts = max(partition_len // frame_step, 1)
                indices = np.linspace(0, partition_len, num=npts)
                indices = np.concatenate(
                    [indices, np.ones(fpc - npts) * partition_len]
                )
                indices = np.clip(indices, 0, partition_len - 1).astype(np.int64)
                indices = indices + i * partition_len
            else:
                sample_len = min(clip_len, total_frames) - 1
                npts = max(sample_len // frame_step, 1)
                indices = np.linspace(0, sample_len, num=npts)
                indices = np.concatenate([indices, np.ones(fpc - npts) * sample_len])
                indices = np.clip(indices, 0, sample_len - 1).astype(np.int64)
                clip_step = 0
                if total_frames > clip_len and num_clips > 1:
                    clip_step = (total_frames - clip_len) // (num_clips - 1)
                indices = indices + i * clip_step
        clips.append(indices)
    return clips


class AVFileDataset:
    """dataset[i] -> (video [T,H,W,3] f32 normalized, mel [128,192] f32, label).

    With ``audio=False`` (video-only layout) the mel slot is None.
    """

    def __init__(
        self,
        csv_paths: Sequence[str],
        layout: TokenLayout,
        frames_per_clip: int = 16,
        frame_step: int = 4,
        num_clips: int = 1,
        random_clip_sampling: bool = True,
        allow_clip_overlap: bool = False,
        filter_short_videos: bool = False,
        filter_long_videos: int = int(1e9),
        duration: Optional[float] = None,
        crop_size: int = 224,
        random_resize_scale=(0.3, 1.0),
        random_resize_aspect_ratio=(0.75, 1.35),
        motion_shift: bool = False,
        horizontal_flip: bool = True,
        reprob: float = 0.0,
        auto_augment: bool = False,
        transform=None,
        seed: int = 0,
    ):
        self.paths, self.labels, self.dataset_ids = load_index(csv_paths)
        if len(self.paths) == 0:
            raise ValueError(f"empty dataset index: {csv_paths}")
        self.layout = layout
        self.frames_per_clip = frames_per_clip
        self.frame_step = frame_step
        self.num_clips = num_clips
        self.random_clip_sampling = random_clip_sampling
        self.allow_clip_overlap = allow_clip_overlap
        self.filter_short_videos = filter_short_videos
        self.filter_long_videos = filter_long_videos
        self.duration = duration
        self.seed = seed
        self.transform = transform or VideoTransform(
            crop_size=crop_size,
            random_resize_scale=random_resize_scale,
            random_resize_aspect_ratio=random_resize_aspect_ratio,
            horizontal_flip=horizontal_flip,
            reprob=reprob,
            motion_shift=motion_shift,
            auto_augment=auto_augment,
        )
        # per-dataset weights support (reference weighted sampler computes
        # sample_weights = dataset_weight / num_samples per dataset)
        self._epoch_salt = 0

    def set_epoch(self, epoch: int) -> None:
        """Salt the per-sample augmentation/clip RNG by the epoch so each
        epoch sees fresh crops/flips/clip positions (the torch DataLoader
        gets this implicitly from worker reseeding; JepaLoader.set_epoch and
        the process-pool tasks call this explicitly)."""
        self._epoch_salt = int(epoch)

    def __len__(self) -> int:
        return len(self.paths)

    def sample_weights(self, dataset_weights: Sequence[float]) -> np.ndarray:
        w = np.zeros(len(self.paths))
        for di, dw in enumerate(dataset_weights):
            sel = self.dataset_ids == di
            n = max(int(sel.sum()), 1)
            w[sel] = dw / n
        return w

    def __getitem__(self, idx: int):
        path = self.paths[idx]
        if os.path.getsize(path) > self.filter_long_videos:
            raise IOError(f"video too large: {path}")
        vf = VideoFile(path)
        if vf.fps <= 0 or not np.isfinite(vf.fps):
            raise IOError(f"invalid fps: {path}")

        fstp = self.frame_step
        if self.duration is not None:
            fstp = max(1, int(self.duration * vf.fps / self.frames_per_clip))
        clip_len = int(self.frames_per_clip * fstp)
        if self.filter_short_videos and vf.num_frames < clip_len:
            raise IOError(f"video too short: {path}")

        rng = np.random.default_rng([self.seed, self._epoch_salt, idx])
        clips_idx = sample_clip_indices(
            vf.num_frames,
            self.frames_per_clip,
            fstp,
            self.num_clips,
            rng,
            self.random_clip_sampling,
            self.allow_clip_overlap,
        )
        all_indices = np.concatenate(clips_idx)
        frames = vf.decode_frames(np.sort(all_indices))
        # re-order to requested order (sorted request for sequential decode)
        order = np.argsort(np.argsort(all_indices, kind="stable"), kind="stable")
        frames = frames[order]

        # transform per clip; concatenate clips along time (loop consumes
        # [num_clips*T, H, W, 3]); num_clips=1 in all pretrain configs
        fpc = self.frames_per_clip
        clips = [
            self.transform(frames[i * fpc : (i + 1) * fpc], rng)
            for i in range(self.num_clips)
        ]
        video = np.concatenate(clips, axis=0) if len(clips) > 1 else clips[0]

        mel = None
        if self.layout.audio_enabled:
            pcm, sr = vf.decode_audio()
            start_frame = int(clips_idx[0][0])
            end_frame = int(clips_idx[-1][-1])
            s0 = int(start_frame / vf.fps * sr)
            s1 = int((end_frame + 1) / vf.fps * sr)
            if s1 > len(pcm):
                raise IOError(f"audio clip exceeds audio length: {path}")
            seg = pcm[s0:s1]
            if len(seg) == 0:
                raise IOError(f"empty audio clip: {path}")
            mel = mel_spectrogram(
                seg,
                sr,
                n_mels=self.layout.spec_height,
                target_width=self.layout.spec_width,
            )
        return video, mel, int(self.labels[idx])
