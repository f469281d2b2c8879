"""LJSpeech offline preprocessing.

Counterpart of the JAX package's ``preprocessing/ljspeech.py``: reads
``metadata.csv`` (pipe-separated, no header, no quoting:
``id|text|text_normalized``), optionally trims each clip into
``wavs_trimmed/``, extracts the 18 prosodic features of every clip
(``audio/prosody.py``; in a process pool when ``n_jobs`` > 1) and writes
``ljspeech-{postfix}.csv``: the features in ``FEATURE_NAMES`` order, then
``text`` (the normalized text) and ``wav``. Rows whose audio is missing or
whose extraction returns None are dropped.
"""

from __future__ import annotations

import csv
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from os import path
from typing import Optional

from tacotron2_tpu_torch.audio.io import read_wav, write_wav
from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES, extract_features_native
from tacotron2_tpu_torch.audio.trim import trim_silence
from tacotron2_tpu_torch.preprocessing.table import write_table


def _process_row(speech_dir: str, trim: bool, trim_top_db: float, row: dict) -> Optional[dict]:
    filepath = path.join(speech_dir, "wavs", f"{row['id']}.wav")
    try:
        wav, sr = read_wav(filepath)
    except (FileNotFoundError, ValueError):
        return None

    wav_rel = path.join("wavs", f"{row['id']}.wav")
    if trim:
        trimmed, _ = trim_silence(wav, top_db=trim_top_db)
        wav_rel = path.join("wavs_trimmed", f"{row['id']}.wav")
        write_wav(path.join(speech_dir, wav_rel), trimmed, sr)
        wav = trimmed

    features = extract_features_native(wav, sr)
    if features is None:
        return None
    features["text"] = row["text_normalized"]
    features["wav"] = wav_rel
    return features


def map_rows(worker, rows: list, n_jobs: int, chunksize: int) -> list:
    """``worker`` over ``rows`` in order, in ``n_jobs`` spawned processes
    when ``n_jobs`` > 1 (each starts from a fresh import: no thread or
    device state of this process is inherited)."""
    if n_jobs <= 1:
        return [worker(r) for r in rows]
    with ProcessPoolExecutor(max_workers=n_jobs,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(worker, rows, chunksize=chunksize))


def do_preprocess(speech_dir: str, out_dir: str, out_postfix: str, n_jobs: int = 8,
                  trim: bool = False, trim_top_db: float = 60.0) -> str:
    with open(path.join(speech_dir, "metadata.csv"), newline="") as f:
        rows = [dict(zip(("id", "text", "text_normalized"), r))
                for r in csv.reader(f, delimiter="|", quoting=csv.QUOTE_NONE) if r]
    if trim:
        os.makedirs(path.join(speech_dir, "wavs_trimmed"), exist_ok=True)
    worker = partial(_process_row, speech_dir, trim, trim_top_db)
    results = [x for x in map_rows(worker, rows, n_jobs, 16) if x is not None]
    out_path = path.join(out_dir, f"ljspeech-{out_postfix}.csv")
    write_table(out_path, [*FEATURE_NAMES, "text", "wav"], results)
    print(f"preprocessed {len(results)}/{len(rows)} utterances -> {out_path}")
    return out_path
