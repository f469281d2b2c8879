"""``test_correlation``: the controllability evaluation of a controllable
config.

Counterpart of ``run/test_correlation.py`` of the JAX package:

- the sweep: each control dimension from -1 to 1 in steps of 0.2, one at a
  time with the others 0, deduped (``control_overrides``);
- the rows: the test manifest (``force_speaker``'s speaker only), up to
  ``utterances_per_speaker`` of each ``speaker_id`` group in sorted order,
  drawn as pandas' ``sample(k, random_state=9001)`` draws them: a fresh
  ``RandomState(9001)`` a group, ``permutation(n)[:k]`` (``sample_rows``);
- for each override, a directory named ``str(override)``: the rows in
  batches of 8, unshuffled, chars bucketed to 32, every row's controls the
  override (the dataset's ``feature_override``) -> the free-running decode
  (kernel K1, its controls rows) with the row's voice (a GST model's
  neutral style, as JAX's passes no reference), one generator a
  batch seeded by the running row count -> each row's ``n`` (the first
  frame whose gate is negative); a row with n == 0 or n >= max_len is
  skipped with JAX's warning; the others vocoded as the port's ``test``
  vocodes them (one HiFi-GAN call over one bucket, kernel K2; JAX vocodes
  each row alone at its exact length, see ``run/test.py``) and written as
  ``{row}.wav`` of n x 256 samples;
- ``analyze_correlations``: per control dimension, the Pearson correlation
  of the override's value with each prosodic feature of the WAVs
  (``audio/prosody.py::extract_features_native``) -> ``correlations.csv``
  (``control|acoustic_feature|pearson_r|n``); the all-zero override gives
  every dimension its 0.0 point.
"""

from __future__ import annotations

import ast
import csv
import os
import time
from os import path
from typing import Dict, List, Optional

import numpy as np
import torch

from tacotron2_tpu_torch.audio.io import read_wav
from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES, extract_features_native
from tacotron2_tpu_torch.config import Config
from tacotron2_tpu_torch.data.loader import TTSDataLoader
from tacotron2_tpu_torch.data.manifest import manifest_dataset, read_manifest, select_rows
from tacotron2_tpu_torch.models.layers import resolve_device, use_f32_math
from tacotron2_tpu_torch.run.say import (MAX_LEN, _sync, load_hifigan, load_tacotron,
                                         refuse_descriptions)
from tacotron2_tpu_torch.run.test import gate_to_lengths, write_rows
from tacotron2_tpu_torch.training.step import to_device

SAMPLE_SEED = 9001


def control_overrides(num_controls: int) -> list:
    """The deduped one-hot sweep, sorted, as tuples of plain floats (their
    ``str`` names the directories)."""
    values = [round(float(x), 1) for x in np.arange(-1.0, 1.2, 0.2)]
    overrides = set()
    for dim in range(num_controls):
        for v in values:
            o = [0.0] * num_controls
            o[dim] = 0.0 if abs(v) < 1e-9 else v
            overrides.add(tuple(o))
    return sorted(overrides)


def sample_rows(rows: List[Dict[str, str]], k: int, seed: int = SAMPLE_SEED) -> list:
    """pandas' ``pd.concat([g.sample(min(len(g), k), random_state=seed) for _,
    g in df.groupby("speaker_id")])`` (the whole table's ``sample`` without a
    ``speaker_id`` column): groups in sorted order of their ids, each drawn
    from a fresh ``RandomState(seed)`` as ``permutation(n)[:k]``."""
    def draw(group):
        idx = np.random.RandomState(seed).permutation(len(group))[:min(len(group), k)]
        return [group[i] for i in idx]

    if not rows or "speaker_id" not in rows[0]:
        return draw(rows)
    groups: Dict[int, list] = {}
    for r in rows:
        groups.setdefault(int(r["speaker_id"]), []).append(r)
    return [r for spk in sorted(groups) for r in draw(groups[spk])]


def do_test_correlation(cfg: Config, speech_dir: str, checkpoint: str,
                        hifi_gan_checkpoint: Optional[str] = None,
                        results_dir: str = "results_correlation",
                        utterances_per_speaker: int = 200, batch_size: int = 8,
                        max_len_override: int = MAX_LEN, analyze: bool = True,
                        device: Optional[str] = None) -> dict:
    """Run the sweep into ``results_dir`` (and ``correlations.csv`` with
    ``analyze``); returns the rows' count, per override (its directory's
    name) each row's ``n``, the WAVs written and per batch its rows,
    executed decode frames and rows vocoded, and the host seconds of the
    decodes and vocodes."""
    ext = cfg.extensions
    if not ext.controls.active:
        raise ValueError("test_correlation requires controls")
    refuse_descriptions(cfg, "test_correlation")
    dev = resolve_device(device)
    if dev.type == "cuda":
        use_f32_math()
    rows = sample_rows(select_rows(cfg, read_manifest(cfg.dataset.test)),
                       utterances_per_speaker)
    model = load_tacotron(cfg, checkpoint, dev)
    hifigan = (None if hifi_gan_checkpoint is None
               else load_hifigan(hifi_gan_checkpoint, dev))
    sr = cfg.dataset.preprocessing.sample_rate
    os.makedirs(results_dir, exist_ok=True)
    record: dict = {"results_dir": results_dir, "rows": len(rows), "overrides": {},
                    "decode_s": 0.0, "vocode_s": 0.0, "device": str(dev)}
    for override in control_overrides(len(ext.controls.features)):
        out_dir = path.join(results_dir, str(tuple(override)))
        os.makedirs(out_dir, exist_ok=True)
        dataset = manifest_dataset(cfg, rows, speech_dir, cache=False, include_text=True,
                                   feature_override=list(override))
        loader = TTSDataLoader(dataset, batch_size=batch_size, shuffle=False, drop_last=False,
                               bucket_chars=32)
        i, lengths, wavs, batches = 0, [], [], []
        for batch in loader:
            b_dev = to_device(batch, dev)
            gen = torch.Generator(device=dev)
            gen.manual_seed(i)
            _sync(dev)
            t0 = time.perf_counter()
            out = model.forward_infer_fast(b_dev["chars_idx"], b_dev["chars_len"],
                                           max_len_override, generator=gen,
                                           speaker_id=b_dev.get("speaker_id"),
                                           controls=b_dev["controls"])
            ns = [int(n) for n in gate_to_lengths(out.gates.cpu().numpy())]
            t1 = time.perf_counter()
            kept = []
            for b, n in enumerate(ns):
                if n == 0 or n >= max_len_override:
                    print(f"warning: degenerate output for {i + b} under {override}")
                else:
                    kept.append(b)
            write_rows(hifigan, out.mels_post, ns, kept, sr, out_dir, i, gl_failures=False)
            _sync(dev)
            record["decode_s"] += t1 - t0
            record["vocode_s"] += time.perf_counter() - t1
            lengths += ns
            wavs += [i + b for b in kept]
            batches.append({"rows": len(ns), "decode_frames": int(out.n_frames),
                            "vocoded": len(kept)})
            i += len(ns)
        record["overrides"][str(tuple(override))] = {"lengths": lengths, "wavs": wavs,
                                                     "batches": batches}
        print(f"override {override}: {i} utterances")
    if analyze:
        record["correlations"] = analyze_correlations(results_dir,
                                                      list(ext.controls.features))
        print(f"wrote {record['correlations']}")
    return record


def analyze_correlations(results_dir: str, control_features) -> str:
    """The Pearson correlations of a finished sweep directory ->
    ``results_dir/correlations.csv`` (pipe-separated:
    control|acoustic_feature|pearson_r|n). A directory whose name is not a
    tuple of the controls' count, or that is not one-hot, is skipped; a
    dimension with fewer than 3 samples or one value gets no rows; a
    feature with fewer than 3 finite values, or no spread, reads nan."""
    per_dim: Dict[int, list] = {d: [] for d in range(len(control_features))}
    for name in sorted(os.listdir(results_dir)):
        full = path.join(results_dir, name)
        if not os.path.isdir(full):
            continue
        try:
            override = tuple(float(x) for x in ast.literal_eval(name))
        except (ValueError, SyntaxError):
            continue
        if len(override) != len(control_features):
            continue
        nz = [i for i, v in enumerate(override) if abs(v) > 1e-9]
        if len(nz) > 1:
            continue
        feats = []
        for f in sorted(os.listdir(full)):
            if f.endswith(".wav"):
                wav, wsr = read_wav(path.join(full, f))
                fd = extract_features_native(wav, wsr)
                if fd is not None:
                    feats.append(fd)
        for d in (nz or range(len(override))):
            per_dim[d].extend((override[d], fd) for fd in feats)

    out = path.join(results_dir, "correlations.csv")
    with open(out, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="|")
        w.writerow(["control", "acoustic_feature", "pearson_r", "n"])
        for d, samples in per_dim.items():
            vals = np.asarray([v for v, _ in samples], np.float64)
            if len(samples) < 3 or np.ptp(vals) < 1e-9:
                continue
            for fname in FEATURE_NAMES:
                ys = np.asarray([fd[fname] for _, fd in samples], np.float64)
                ok = np.isfinite(ys)
                if ok.sum() < 3 or np.std(ys[ok]) < 1e-12 or np.std(vals[ok]) < 1e-12:
                    r = float("nan")
                else:
                    r = float(np.corrcoef(vals[ok], ys[ok])[0, 1])
                w.writerow([control_features[d], fname, f"{r:.4f}", int(ok.sum())])
    return out
