"""Mel spectrogram, librosa-compatible, in pure numpy/scipy (the port's copy
of ``avjepa_tpu/data/mel.py``).

The reference computes (src/datasets/audiovideo_dataset.py:317-349):
    S    = librosa.stft(y, n_fft=2048, hop_length=512, window='hann')  # center
    mel  = librosa.feature.melspectrogram(S=np.abs(S), sr=sr, n_mels=128)
    sdb  = librosa.power_to_db(mel, ref=np.max, top_db=80)
    sgram = scipy.ndimage.zoom(sdb, (1, 192/W), order=1)     # width -> 192

Note the reference passes the *magnitude* (not power) spectrogram into the mel
projection — we replicate that quirk. The slaney mel filterbank and
power_to_db follow librosa's formulas exactly.
"""

from __future__ import annotations

import numpy as np
from scipy.ndimage import zoom


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann (scipy.signal.get_window('hann', n, fftbins=True))."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def stft_magnitude(
    y: np.ndarray, n_fft: int = 2048, hop_length: int = 512, center: bool = True
) -> np.ndarray:
    """|STFT| with centered frames and zero padding (librosa defaults)."""
    y = np.asarray(y, np.float32)
    if center:
        y = np.pad(y, (n_fft // 2, n_fft // 2), mode="constant")
    if len(y) < n_fft:
        y = np.pad(y, (0, n_fft - len(y)), mode="constant")
    n_frames = 1 + (len(y) - n_fft) // hop_length
    idx = np.arange(n_fft)[None, :] + hop_length * np.arange(n_frames)[:, None]
    frames = y[idx] * hann_window(n_fft)[None, :]
    spec = np.fft.rfft(frames, axis=1)
    return np.abs(spec).T.astype(np.float32)  # [1 + n_fft//2, n_frames]


def _hz_to_mel_slaney(f: np.ndarray) -> np.ndarray:
    f = np.asarray(f, np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = f >= min_log_hz
    mels = np.where(log_region, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)
    return mels


def _mel_to_hz_slaney(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = m >= min_log_mel
    freqs = np.where(log_region, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


def mel_filterbank(
    sr: int, n_fft: int = 2048, n_mels: int = 128, fmin: float = 0.0,
    fmax: float | None = None,
) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank (librosa.filters.mel)."""
    if fmax is None:
        fmax = sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)

    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    # slaney normalization
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]
    return weights.astype(np.float32)


def power_to_db(
    s: np.ndarray, ref: float | None = None, amin: float = 1e-10, top_db: float = 80.0
) -> np.ndarray:
    s = np.asarray(s, np.float64)
    if ref is None:
        ref = float(np.max(s))
    db = 10.0 * np.log10(np.maximum(amin, s))
    db -= 10.0 * np.log10(max(amin, abs(ref)))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db.astype(np.float32)


def mel_spectrogram(
    y: np.ndarray,
    sr: int,
    n_fft: int = 2048,
    hop_length: int = 512,
    n_mels: int = 128,
    target_width: int = 192,
    top_db: float = 80.0,
) -> np.ndarray:
    """PCM -> [n_mels, target_width] dB spectrogram (the reference pipeline)."""
    mag = stft_magnitude(y, n_fft=n_fft, hop_length=hop_length)
    fb = mel_filterbank(sr, n_fft=n_fft, n_mels=n_mels)
    mel = fb @ mag  # reference quirk: magnitude, not power
    sdb = power_to_db(mel, top_db=top_db)
    w = sdb.shape[1]
    if w != target_width:
        sdb = zoom(sdb, (1, target_width / w), order=1)
        # zoom rounds the output size; enforce exactly target_width
        if sdb.shape[1] > target_width:
            sdb = sdb[:, :target_width]
        elif sdb.shape[1] < target_width:
            sdb = np.pad(sdb, ((0, 0), (0, target_width - sdb.shape[1])), mode="edge")
    return sdb.astype(np.float32)
