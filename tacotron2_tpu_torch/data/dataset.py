"""TTS dataset: WAV -> log-mel and gate targets, text -> char indices.

Counterpart of ``tacotron2_tpu/data/dataset.py`` with speaker ids,
control features (and their override) and description embeddings:

- texts are normalized once, at construction (transliterate -> lower ->
  strip -> [expand abbreviations] -> end token), then ordinal-encoded + 1;
- audio: read the WAV or FLAC (``load_audio``) -> [trim silence] -> append ``silence`` zero samples
  -> log-mel (frames, n_mels), optionally cached per file under a tag of
  the preprocessing parameters (each cache file written whole, then
  renamed into place, so a concurrent reader never sees part of one);
- the gate target is ones with the LAST frame 0 (stop is the gate going
  low, the reference's convention);
- the metadata carry ``speaker_id`` (int64) and ``features`` (f32, the
  controls; ``feature_override``, one vector for every row, in their place:
  ``test_correlation``'s sweep) where the dataset was given them;
- ``description_embeddings``: a path per row (relative to ``base_dir``) of
  a ``.npy`` or ``.pt`` file, read as (1, dim) f32; None gives zeros (1,
  ``description_embeddings_dim``). With ``description_embeddings_augment``
  each read picks one of the file and those of ``<stem>_augmentations/``,
  from a generator seeded by (``seed``, row, the row's reads so far), so a
  loader's seed gives one sequence of picks; JAX draws from the global
  ``random``, so the picks are held as a set, not bit for bit;
  ``include_text`` and
  ``include_filename`` put the normalized text and the file name in the
  item's third dict, which the collate passes through as lists.

Items are ``(data, metadata, extra)`` dicts as in the JAX package, so the
collate is the same.
"""

from __future__ import annotations

import hashlib
import os
import threading
from collections import defaultdict
from os import path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tacotron2_tpu_torch.audio.io import load_audio
from tacotron2_tpu_torch.audio.mel import TacotronMelSpectrogram
from tacotron2_tpu_torch.audio.trim import trim_silence
from tacotron2_tpu_torch.config import ALLOWED_CHARS
from tacotron2_tpu_torch.text import CharEncoder, normalize_text


class TTSDataset:
    def __init__(self, filenames: List[str], texts: List[str], base_dir: str,
                 speaker_ids: Optional[List[int]] = None, features=None,
                 allowed_chars: str = ALLOWED_CHARS, end_token: Optional[str] = "^",
                 silence: int = 0, trim: bool = True, trim_top_db: float = 60,
                 trim_frame_length: int = 2048, expand_abbreviations: bool = False,
                 num_mels: int = 80, cache: bool = False, cache_dir: Optional[str] = None,
                 sample_rate: int = 22050, include_text: bool = False,
                 include_filename: bool = False, feature_override=None,
                 description_embeddings: Optional[List[Optional[str]]] = None,
                 description_embeddings_dim: int = 768,
                 description_embeddings_augment: bool = False, seed: int = 0):
        if cache and cache_dir is None:
            raise ValueError("If caching spectrograms, a cache directory is required")
        if cache:
            os.makedirs(cache_dir, exist_ok=True)
        self.filenames, self.base_dir = filenames, base_dir
        self.speaker_ids, self.features = speaker_ids, features
        self.feature_override = feature_override
        self.description_embeddings = description_embeddings
        self.description_embeddings_dim = description_embeddings_dim
        self.description_embeddings_augment = description_embeddings_augment
        self.seed = seed
        self._reads: Dict[int, int] = defaultdict(int)
        self.cache, self.cache_dir = cache, cache_dir
        self.trim, self.trim_top_db, self.trim_frame_length = trim, trim_top_db, trim_frame_length
        self.silence = silence
        self.include_text, self.include_filename = include_text, include_filename
        self.texts = [normalize_text(t, allowed_chars, end_token, expand_abbreviations)
                      for t in texts]
        self.encoder = CharEncoder(allowed_chars, end_token)
        self.melspectrogram = TacotronMelSpectrogram(n_mels=num_mels, sample_rate=sample_rate)
        key = f"{trim}|{trim_top_db}|{trim_frame_length}|{silence}|{num_mels}|{sample_rate}"
        self._cache_tag = hashlib.sha1(key.encode()).hexdigest()[:8]

    def __len__(self) -> int:
        return len(self.filenames)

    def _mel(self, i: int) -> np.ndarray:
        filename = self.filenames[i]
        cache_path = None
        if self.cache:
            cache_path = path.join(self.cache_dir,
                                   f"{filename.replace('/', '_')}.{self._cache_tag}.npy")
            if path.exists(cache_path):
                return np.load(cache_path)
        wav, _ = load_audio(path.join(self.base_dir, filename))
        if self.trim:
            wav, _ = trim_silence(wav, top_db=self.trim_top_db,
                                  frame_length=self.trim_frame_length)
        mel = self.melspectrogram(np.pad(wav, (0, self.silence)))
        if cache_path is not None:
            # written whole under a name of this thread's, then renamed: a
            # loader thread reading the same file (a row twice in a batch)
            # finds it whole or not at all
            tmp = f"{cache_path}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, mel)
            os.replace(tmp, cache_path)
        return mel

    def description_choices(self, i: int) -> List[str]:
        """Row i's embedding file, and with augmentation those of its
        ``<stem>_augmentations`` directory (sorted)."""
        full = path.join(self.base_dir, self.description_embeddings[i])
        if not self.description_embeddings_augment:
            return [full]
        aug_dir = full.replace(".pt", "_augmentations").replace(".npy", "_augmentations")
        extra = (sorted(x for x in os.listdir(aug_dir) if x.endswith((".pt", ".npy")))
                 if path.isdir(aug_dir) else [])
        return [full] + [path.join(aug_dir, x) for x in extra]

    def _description_embedding(self, i: int) -> np.ndarray:
        if self.description_embeddings[i] is None:
            return np.zeros((1, self.description_embeddings_dim), np.float32)
        choices = self.description_choices(i)
        if len(choices) > 1:
            rng = np.random.default_rng([self.seed, i, self._reads[i]])
            self._reads[i] += 1
            choices = [choices[int(rng.integers(len(choices)))]]
        if choices[0].endswith(".pt"):
            emb = torch.load(choices[0], map_location="cpu", weights_only=True).numpy()
        else:
            emb = np.load(choices[0])
        return emb.astype(np.float32).reshape(1, -1)

    def __getitem__(self, i: int) -> Tuple[Dict[str, Any], Dict[str, Any], Dict[str, Any]]:
        mel = self._mel(i)
        T = len(mel)
        gate = np.ones((T, 1), np.float32)
        gate[-1] = 0.0
        chars_idx = self.encoder.encode(self.texts[i])
        data = {"chars_idx": chars_idx, "mel_spectrogram": mel.astype(np.float32), "gate": gate}
        meta = {"chars_idx_len": np.int64(len(chars_idx)), "mel_spectrogram_len": np.int64(T),
                "gate_len": np.int64(T)}
        if self.speaker_ids is not None:
            meta["speaker_id"] = np.int64(self.speaker_ids[i])
        if self.description_embeddings is not None:
            meta["description_embeddings"] = self._description_embedding(i)
        if self.features is not None:
            meta["features"] = np.asarray(self.features[i] if self.feature_override is None
                                          else self.feature_override, np.float32)
        extra = {}
        if self.include_text:
            extra["text"] = self.texts[i]
        if self.include_filename:
            extra["filename"] = self.filenames[i]
        return data, meta, extra
