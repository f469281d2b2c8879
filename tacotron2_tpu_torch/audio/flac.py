"""FLAC decode through the native decoder (``native/flac_decoder.cpp``).

Counterpart of ``tacotron2_tpu/audio/flac.py``: one ctypes call returns
interleaved int32 PCM, normalized to float32 like the WAV reader. The
library is the port's own build (``ops/native.py``). A file the decoder
refuses raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
from os import path
from typing import Tuple

import numpy as np

from tacotron2_tpu_torch.ops import native


def read_flac(filepath: str, mono: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float32 samples in [-1, 1], sample_rate);
    channels averaged with ``mono``, else (frames, channels)."""
    if not path.exists(filepath):
        raise FileNotFoundError(filepath)
    lib = native.load()
    samples = ctypes.POINTER(ctypes.c_int32)()
    n_frames, channels = ctypes.c_int64(), ctypes.c_int()
    rate, bits = ctypes.c_int(), ctypes.c_int()
    rc = lib.flac_decode_file(filepath.encode(), ctypes.byref(samples), ctypes.byref(n_frames),
                              ctypes.byref(channels), ctypes.byref(rate), ctypes.byref(bits))
    if rc != 0:
        raise ValueError(f"FLAC decode failed for {filepath} (code {rc})")
    try:
        total = n_frames.value * channels.value
        arr = np.ctypeslib.as_array(samples, shape=(total,)).copy()
    finally:
        lib.flac_free(samples)
    arr = arr.reshape(n_frames.value, channels.value).astype(np.float32)
    arr /= float(1 << (bits.value - 1))
    if mono and channels.value > 1:
        arr = arr.mean(axis=1)
    else:
        arr = arr[:, 0] if mono else arr
    return np.ascontiguousarray(arr), rate.value
