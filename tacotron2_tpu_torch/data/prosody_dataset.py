"""Prosody-training dataset: random fixed-size mel / wav segment pairs.

Counterpart of ``tacotron2_tpu/data/prosody_dataset.py`` (the reference's
datasets/prosody_dataset.py): per file, the trimmed waveform's log-mel, a
random ``spectrogram_segment_size``-frame segment (padded with log(1e-5)
past a short clip's end), the waveform segment under it (the wav padded by
hop / 2 on both sides, as the reference pads it), and the segment's
prosodic features (``audio/prosody.py::extract_features_native``, which
JAX's ``extract_features`` runs where the native library builds; zeros
where the extractor gives none). The segment's start comes from ``random.Random(seed)``,
so one seed and the same files draw JAX's segments.
"""

from __future__ import annotations

import random
from os import path
from typing import List, Optional

import numpy as np

from tacotron2_tpu_torch.audio.io import load_audio
from tacotron2_tpu_torch.audio.mel import TacotronMelSpectrogram
from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES, extract_features_native
from tacotron2_tpu_torch.audio.trim import trim_silence


class ProsodyDataset:
    def __init__(self, filenames: List[str], base_dir: str, sample_rate: int = 22050,
                 n_fft: int = 1024, win_length: int = 1024, hop_length: int = 256,
                 f_min: float = 0.0, f_max: float = 8000.0, n_mels: int = 80, trim: bool = True,
                 spectrogram_segment_size: int = 64, features: Optional[List[str]] = None,
                 seed: Optional[int] = None):
        self.filenames, self.base_dir = filenames, base_dir
        self.trim, self.segment = trim, spectrogram_segment_size
        self.hop_length, self.sample_rate = hop_length, sample_rate
        self.feature_names = features or FEATURE_NAMES
        self.melspectrogram = TacotronMelSpectrogram(n_mels=n_mels, sample_rate=sample_rate,
                                                     n_fft=n_fft, win_length=win_length,
                                                     hop_length=hop_length, f_min=f_min,
                                                     f_max=f_max)
        self._rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, i: int) -> dict:
        wav, _ = load_audio(path.join(self.base_dir, self.filenames[i]))
        if self.trim:
            wav, _ = trim_silence(wav, frame_length=512)
        mel = self.melspectrogram(wav)
        last = max(len(mel) - self.segment, 0)
        start = self._rng.randint(0, last) if last else 0
        end = start + self.segment
        mel_segment = mel[start:end]
        if len(mel_segment) < self.segment:
            mel_segment = np.pad(mel_segment, ((0, self.segment - len(mel_segment)), (0, 0)),
                                 constant_values=np.log(1e-5))
        half = self.hop_length // 2
        wav_segment = np.pad(wav, (half, half))[start * self.hop_length:end * self.hop_length]
        feats = extract_features_native(wav_segment, self.sample_rate) or {}
        return {"mel_segment": mel_segment.astype(np.float32),
                "wav_segment": wav_segment.astype(np.float32),
                "features": np.asarray([feats.get(k, 0.0) for k in self.feature_names],
                                       np.float32)}
