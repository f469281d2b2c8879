"""Hi-Fi TTS offline preprocessing.

Counterpart of the JAX package's ``preprocessing/hifi_tts.py``: parses the
NeMo-style ``{speaker}_manifest_clean_{set}.json`` manifests (JSON lines),
decodes each clip (FLAC through the native decoder), resamples it to
22,050 Hz with clip prevention (polyphase, then peaks rescaled to 0.99 where
they pass it), writes it as WAV under ``audio_22050/`` (the ``audio/`` path
rewritten), optionally trims it into ``audio_22050_trimmed/``, extracts the
18 prosodic features, and writes ``hifi-tts-{train,val,test}-{postfix}.csv``
(the dev set is ``val``) with the dataset's speaker ids ordinally encoded
0..N-1 by the train set's sorted ids.
"""

from __future__ import annotations

import json
import os
from functools import partial
from math import gcd
from os import path
from typing import List, Optional

import numpy as np

from tacotron2_tpu_torch.audio.io import load_audio, write_wav
from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES, extract_features_native
from tacotron2_tpu_torch.audio.trim import trim_silence
from tacotron2_tpu_torch.preprocessing.ljspeech import map_rows
from tacotron2_tpu_torch.preprocessing.table import write_table

TARGET_SR = 22050
COLUMNS = [*FEATURE_NAMES, "speaker_id_dataset", "text", "wav", "speaker_id"]


def _load_set(base_dir: str, set_name: str) -> List[dict]:
    """The set's JSON lines, speakers in ``os.listdir``'s order, each row
    with its ``speaker_id`` (the file name's prefix)."""
    rows = []
    for file in (x for x in os.listdir(base_dir) if "clean" in x and set_name in x):
        speaker = file.split("_")[0]
        with open(path.join(base_dir, f"{speaker}_manifest_clean_{set_name}.json")) as infile:
            for line in infile:
                data = json.loads(line)
                data["speaker_id"] = speaker
                rows.append(data)
    return rows


def resample_no_clip(wav: np.ndarray, sr: int, target_sr: int = TARGET_SR) -> np.ndarray:
    """Polyphase resample; peaks rescaled to 0.99 where the result passes it."""
    if sr != target_sr:
        from scipy.signal import resample_poly

        g = gcd(target_sr, sr)
        wav = resample_poly(wav.astype(np.float64), target_sr // g, sr // g).astype(np.float32)
    peak = np.max(np.abs(wav)) if len(wav) else 0.0
    if peak > 0.99:
        wav = wav * (0.99 / peak)
    return wav


def _process_row(speech_dir: str, trim: bool, trim_top_db: float, row: dict) -> Optional[dict]:
    filepath = row["audio_filepath"]
    try:
        wav, sr = load_audio(path.join(speech_dir, filepath))
    except (FileNotFoundError, ValueError):
        return None
    wav = resample_no_clip(wav, sr)

    resampled_rel = "audio_22050" + filepath[5:].replace("flac", "wav")
    out_path = path.join(speech_dir, resampled_rel)
    os.makedirs(path.dirname(out_path), exist_ok=True)
    write_wav(out_path, wav, TARGET_SR)
    final_rel = resampled_rel

    if trim:
        trimmed_rel = "audio_22050_trimmed" + filepath[5:].replace("flac", "wav")
        trimmed, _ = trim_silence(wav, top_db=trim_top_db)
        t_path = path.join(speech_dir, trimmed_rel)
        os.makedirs(path.dirname(t_path), exist_ok=True)
        write_wav(t_path, trimmed, TARGET_SR)
        wav = trimmed
        final_rel = trimmed_rel

    features = extract_features_native(wav, TARGET_SR)
    if features is None:
        return None
    features["speaker_id_dataset"] = int(row["speaker_id"])
    features["text"] = row.get("text_normalized")
    features["wav"] = final_rel
    return features


def do_preprocess(speech_dir: str, out_dir: str, out_postfix: str, n_jobs: int = 8,
                  trim: bool = False, trim_top_db: float = 60.0) -> List[str]:
    # the three sets' rows through one process pool, in order
    loaded = {name: _load_set(speech_dir, src)
              for name, src in (("train", "train"), ("val", "dev"), ("test", "test"))}
    worker = partial(_process_row, speech_dir, trim, trim_top_db)
    results = iter(map_rows(worker, [r for rows in loaded.values() for r in rows], n_jobs, 8))
    sets = {name: [x for x in (next(results) for _ in rows) if x is not None]
            for name, rows in loaded.items()}
    mapping = {c: i for i, c in enumerate(sorted({r["speaker_id_dataset"]
                                                   for r in sets["train"]}))}
    outs = []
    for name, rows in sets.items():
        for r in rows:
            if r["speaker_id_dataset"] not in mapping:
                raise ValueError(f"speaker {r['speaker_id_dataset']} of the {name} set is not "
                                 "in the train set")
            r["speaker_id"] = mapping[r["speaker_id_dataset"]]
        outs.append(path.join(out_dir, f"hifi-tts-{name}-{out_postfix}.csv"))
        write_table(outs[-1], COLUMNS, rows)
    print(f"hifi-tts: train {len(sets['train'])}, val {len(sets['val'])}, "
          f"test {len(sets['test'])}")
    return outs
