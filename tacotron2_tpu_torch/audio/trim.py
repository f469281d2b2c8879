"""Silence trimming, as ``librosa.effects.trim`` computes it.

Counterpart of ``tacotron2_tpu/audio/trim.py`` (host-side numpy): frame-wise
RMS power over centered, zero-padded frames (hop 512), in dB against the
loudest frame; frames above ``-top_db`` are non-silent, and the signal is cut
at the first and last non-silent frame boundaries.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _frame_rms(y: np.ndarray, frame_length: int, hop_length: int) -> np.ndarray:
    # windowed mean of squares from an f64 running sum (exact dB decisions)
    sq = np.pad(y.astype(np.float64) ** 2, frame_length // 2, mode="constant")
    num_frames = 1 + (len(sq) - frame_length) // hop_length
    c = np.concatenate([[0.0], np.cumsum(sq)])
    starts = np.arange(num_frames) * hop_length
    return np.sqrt((c[starts + frame_length] - c[starts]) / frame_length)


def trim_silence(y: np.ndarray, top_db: float = 60.0, frame_length: int = 2048,
                 hop_length: int = 512) -> Tuple[np.ndarray, Tuple[int, int]]:
    """-> (trimmed, (start, end)), like librosa.effects.trim."""
    y = np.asarray(y)
    power = _frame_rms(y, frame_length, hop_length) ** 2
    ref = power.max()
    nz = np.flatnonzero(power > ref * (10.0 ** (-top_db / 10.0))) if ref > 0 else []
    if len(nz) == 0:
        return y[0:0], (0, 0)
    start = int(nz[0] * hop_length)
    end = min(len(y), int((nz[-1] + 1) * hop_length))
    return y[start:end], (start, end)
