"""Prosodic feature extraction — the offline preprocessing analyzer.

Counterpart of ``tacotron2_tpu/audio/prosody.py`` (numpy and the native
library, no torch), the same math. ``preprocess`` calls the native
extractor alone, so a failed build or load raises; the numpy one is the
reference it is tested against.

The reference extracts 18 prosodic features per utterance through
``speech_utils.preprocessing.feature_extraction.extract_features`` (Praat
via praat-parselmouth — preprocessing/ljspeech.py:33-35, hifi_tts.py:87-94;
feature names enumerated in preprocessing_split/normalize.py:1-21). Neither
speech_utils nor Praat is a dependency, so this module defines the
framework's own DSP (documented below); values are *scale-consistent* with
the reference's columns but not bit-identical to Praat. Because the
normalization step rescales every feature to median±3σ -> [-1, 1]
(normalize.py:48-56) from the SAME extractor's statistics, the downstream
controls contract is preserved.

Definitions:
- pitch: per-frame autocorrelation F0 (75-600 Hz, 40 ms frames, 10 ms hop,
  parabolic interpolation); voiced = autocorr peak > 0.45 & above noise
  floor. pitch_* stats are log10(Hz) over voiced frames (matching the
  reference CSVs' ~2.1-2.4 magnitudes); pitch_range = p95 - p5;
  *_log variants are natural-log Hz.
- intensity: frame dB re 2e-5 (Praat's reference pressure);
  intensity_mean_vcd over voiced frames only.
- jitter: mean |ΔT_i| / mean T over consecutive voiced pitch periods
  (Praat's "local jitter").
- shimmer: mean |ΔA_i| / mean A over consecutive period peak amplitudes.
- nhr: mean (1 - r) / r over frames, r = normalized autocorrelation peak
  (noise-to-harmonics); nhr_vcd over voiced frames.
- rate: intensity-envelope peak rate (syllable-nuclei proxy) per second;
  rate_vcd per voiced second.

A C++ implementation of the same math lives in native/ (ctypes-loaded, the
port's own build: ``ops/native.py``); this numpy version is the semantic
reference and fallback.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

FEATURE_NAMES = [
    "duration",
    "duration_vcd",
    "pitch_mean",
    "pitch_5",
    "pitch_95",
    "pitch_range",
    "pitch_mean_log",
    "pitch_5_log",
    "pitch_95_log",
    "pitch_range_log",
    "intensity_mean",
    "intensity_mean_vcd",
    "jitter",
    "shimmer",
    "nhr",
    "nhr_vcd",
    "rate",
    "rate_vcd",
]

_P_REF = 2e-5  # Praat intensity reference pressure
F0_MIN, F0_MAX = 75.0, 600.0
VOICING_THRESHOLD = 0.45


def _frames(y: np.ndarray, frame: int, hop: int) -> np.ndarray:
    n = max(0, 1 + (len(y) - frame) // hop)
    idx = np.arange(n)[:, None] * hop + np.arange(frame)[None, :]
    return y[idx] if n else np.zeros((0, frame), y.dtype)


def _autocorr_f0(frames: np.ndarray, sr: int):
    """Normalized-autocorrelation F0 per frame -> (f0 Hz, peak r)."""
    n_frames, frame = frames.shape
    if n_frames == 0:
        return np.zeros(0), np.zeros(0)
    x = frames - frames.mean(axis=1, keepdims=True)
    # FFT autocorrelation
    nfft = 1 << int(math.ceil(math.log2(2 * frame)))
    spec = np.fft.rfft(x, nfft, axis=1)
    ac = np.fft.irfft(spec * np.conj(spec), nfft, axis=1)[:, :frame]
    ac0 = np.maximum(ac[:, 0], 1e-12)
    acn = ac / ac0[:, None]

    lag_min = int(sr / F0_MAX)
    lag_max = min(int(sr / F0_MIN), frame - 2)
    window = acn[:, lag_min : lag_max + 1]
    best = np.argmax(window, axis=1)
    r = window[np.arange(n_frames), best]
    lag = best + lag_min
    # parabolic interpolation around the peak
    l0 = np.clip(lag, lag_min + 1, lag_max - 1)
    ym1 = acn[np.arange(n_frames), l0 - 1]
    y0 = acn[np.arange(n_frames), l0]
    yp1 = acn[np.arange(n_frames), l0 + 1]
    denom = ym1 - 2 * y0 + yp1
    delta = np.where(np.abs(denom) > 1e-12, 0.5 * (ym1 - yp1) / np.where(np.abs(denom) > 1e-12, denom, 1.0), 0.0)
    delta = np.clip(delta, -0.5, 0.5)
    f0 = sr / (l0 + delta)
    return f0, r


def extract_features_native(
    wav: np.ndarray,
    sr: int = 22050,
    frame_ms: float = 40.0,
    hop_ms: float = 10.0,
) -> Optional[Dict[str, float]]:
    """The 18 prosodic features via the C++ backend (native/prosody.cpp),
    parity-tested against the numpy reference below. Returns None for
    degenerate audio (the reference drops rows whose extraction fails,
    preprocessing/ljspeech.py:37-38)."""
    import ctypes

    from tacotron2_tpu_torch.ops import native

    lib = native.load()
    wav32 = np.ascontiguousarray(wav, dtype=np.float32)
    out = (ctypes.c_double * len(FEATURE_NAMES))()
    rc = lib.prosody_extract(
        wav32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(wav32), sr, frame_ms, hop_ms, out,
    )
    if rc != 0:
        return None
    return dict(zip(FEATURE_NAMES, out))


def _extract_features_numpy(
    wav: np.ndarray,
    sr: int = 22050,
    transcript: Optional[str] = None,
    frame_ms: float = 40.0,
    hop_ms: float = 10.0,
) -> Optional[Dict[str, float]]:
    """Numpy reference implementation (the semantic spec)."""
    wav = np.asarray(wav, dtype=np.float64).reshape(-1)
    duration = len(wav) / sr
    if duration < 0.05 or np.max(np.abs(wav)) < 1e-6:
        return None

    frame = int(sr * frame_ms / 1000)
    hop = int(sr * hop_ms / 1000)
    frames = _frames(wav, frame, hop)
    if len(frames) < 3:
        return None

    # intensity ------------------------------------------------------
    power = np.mean(frames**2, axis=1)
    intensity_db = 10.0 * np.log10(np.maximum(power, 1e-20) / _P_REF**2)

    # pitch + voicing ------------------------------------------------
    f0, r = _autocorr_f0(frames, sr)
    # voiced = periodic AND within 35 dB of the utterance's peak intensity
    # (a silence gate; Praat's pitch algorithm uses a similar dual criterion)
    energy_floor = np.max(intensity_db) - 35.0
    voiced = (r > VOICING_THRESHOLD) & (intensity_db > energy_floor)
    if voiced.sum() < 3:
        return None
    f0v = f0[voiced]
    duration_vcd = float(voiced.sum() * hop / sr)

    p5, p95 = np.percentile(np.log10(f0v), [5, 95])
    pitch_mean = float(np.mean(np.log10(f0v)))
    p5_log, p95_log = np.percentile(np.log(f0v), [5, 95])
    pitch_mean_log = float(np.mean(np.log(f0v)))

    # jitter / shimmer over consecutive voiced periods -----------------
    periods = 1.0 / f0v
    jitter = float(np.mean(np.abs(np.diff(periods))) / max(np.mean(periods), 1e-12))
    amps = np.sqrt(np.maximum(power[voiced], 1e-20))
    shimmer = float(np.mean(np.abs(np.diff(amps))) / max(np.mean(amps), 1e-12))

    # noise-to-harmonics ----------------------------------------------
    r_clip = np.clip(r, 1e-3, 1 - 1e-6)
    nhr_all = (1.0 - r_clip) / r_clip
    nhr = float(np.mean(np.clip(nhr_all, 0.0, 10.0)))
    nhr_vcd = float(np.mean(np.clip(nhr_all[voiced], 0.0, 10.0)))

    # speaking rate: intensity-envelope peaks (syllable nuclei proxy) ----
    env = intensity_db.copy()
    k = max(1, int(50 / hop_ms))  # ~50 ms smoothing
    kernel = np.ones(k) / k
    env = np.convolve(env, kernel, mode="same")
    thresh = np.median(env)
    peaks = 0
    for i in range(1, len(env) - 1):
        if env[i] > env[i - 1] and env[i] >= env[i + 1] and env[i] > thresh:
            peaks += 1
    rate = peaks / duration
    rate_vcd = peaks / max(duration_vcd, 1e-6)

    return {
        "duration": float(duration),
        "duration_vcd": duration_vcd,
        "pitch_mean": pitch_mean,
        "pitch_5": float(p5),
        "pitch_95": float(p95),
        "pitch_range": float(p95 - p5),
        "pitch_mean_log": pitch_mean_log,
        "pitch_5_log": float(p5_log),
        "pitch_95_log": float(p95_log),
        "pitch_range_log": float(p95_log - p5_log),
        "intensity_mean": float(np.mean(intensity_db)),
        "intensity_mean_vcd": float(np.mean(intensity_db[voiced])),
        "jitter": jitter,
        "shimmer": shimmer,
        "nhr": nhr,
        "nhr_vcd": nhr_vcd,
        "rate": float(rate),
        "rate_vcd": float(rate_vcd),
    }
