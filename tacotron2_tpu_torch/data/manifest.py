"""Manifests: the pipe-separated CSVs that ``train``, ``test`` and
``train_mel_export`` read, and the dataset of their rows.

Counterpart of the JAX package's ``run/common.py::read_manifest`` (pandas
there, the ``csv`` module here) and of the dataset arguments its commands
build from a manifest: the ``wav`` and ``text`` columns, with speaker tokens
the ``speaker_id`` column (int), with controls the config's
``extensions.controls.features`` columns (float; an empty field is NaN, as
pandas reads it), with description embeddings the paths that ``train``
selects (``description_embedding`` column, an empty field None).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional

from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.dataset import TTSDataset


def read_manifest(csv_path: str) -> List[Dict[str, str]]:
    """Pipe-separated rows with a header row, no quoting."""
    with open(csv_path, newline="") as f:
        return list(csv.DictReader(f, delimiter="|", quoting=csv.QUOTE_NONE))


def select_rows(cfg: Config, rows: List[Dict[str, str]]) -> List[Dict[str, str]]:
    """With ``force_speaker``, the manifest rows of that speaker only (JAX
    ``run/train.py``: ``df[df.speaker_id == force_speaker]``)."""
    fs = cfg.extensions.speaker_tokens.force_speaker
    return rows if fs is None else [r for r in rows if int(r["speaker_id"]) == fs]


def _float(field: str) -> float:
    return float(field) if field else float("nan")


def manifest_dataset(cfg: Config, rows: List[Dict[str, str]], speech_dir: str,
                     cache: Optional[bool] = None, cache_dir: Optional[str] = None,
                     include_text: bool = False, include_filename: bool = False,
                     feature_override=None,
                     descriptions: Optional[List[Optional[str]]] = None,
                     description_augment: bool = False, seed: int = 0) -> TTSDataset:
    """The rows' dataset under the config's preprocessing; ``cache``
    overrides the config's (``test`` and ``train_mel_export`` make one pass
    and cache nothing). ``descriptions``: each row's description-embedding
    path or None (``train``'s selection), of the config's
    ``description_embeddings_dim`` (768 where it is 0, as JAX's ``train``),
    picked among their augmentations with ``description_augment``."""
    p, ext = cfg.dataset.preprocessing, cfg.extensions
    speakers = [int(r["speaker_id"]) for r in rows] if ext.speaker_tokens.active else None
    features = ([[_float(r[f]) for f in ext.controls.features] for r in rows]
                if ext.controls.active else None)
    return TTSDataset(
        [r["wav"] for r in rows], [r["text"] for r in rows], speech_dir,
        speaker_ids=speakers, features=features, allowed_chars=p.allowed_chars,
        end_token=p.end_token, silence=p.silence, trim=p.trim,
        trim_top_db=p.trim_top_db, trim_frame_length=p.trim_frame_length,
        expand_abbreviations=p.expand_abbreviations, num_mels=p.num_mels,
        cache=p.cache if cache is None else cache, cache_dir=cache_dir,
        sample_rate=p.sample_rate, include_text=include_text,
        include_filename=include_filename, feature_override=feature_override,
        description_embeddings=descriptions,
        description_embeddings_dim=cfg.model.description_embeddings_dim or 768,
        description_embeddings_augment=description_augment, seed=seed)
