"""Dataset splits and feature normalization, on numpy and the ``csv`` module.

Counterpart of the JAX package's ``preprocessing/splits.py`` (pandas,
scikit-learn and click there), with their semantics kept:

- ``train_test_split(rows, n, r)`` is scikit-learn's with an integer test
  size: ``p = RandomState(r).permutation(len(rows))``, test ``p[:n]``, train
  ``p[n:]``, each in that order;
- medians and standard deviations skip NaN and the deviation has ddof=1
  (``DataFrame.median`` / ``.std``); an empty field is NaN and NaN is
  written as an empty field;
- a group-wise normalization returns the rows grouped by sorted key, each
  group in its order (``groupby`` + ``concat``); new columns go at the end;
- columns read are written back as read (ints stay ints).

Normalization (the reference's normalize.py): each feature's median +- 3
standard deviations over the TRAIN split mapped linearly to [-1, 1], plus
``_clip`` variants clipped to that range; families: dataset, speaker,
dataset_gender.

    python -m tacotron2_tpu_torch.preprocessing.splits ljspeech --csv-in ... --train-out ...
    python -m tacotron2_tpu_torch.preprocessing.splits hifi --train-in ... ...
    python -m tacotron2_tpu_torch.preprocessing.splits lj-hifi --hifi-train-in ... ...
    python -m tacotron2_tpu_torch.preprocessing.splits libritts-index --libritts-dir ...
"""

from __future__ import annotations

import argparse
import csv
import os
import warnings
from os import path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tacotron2_tpu_torch.audio.prosody import FEATURE_NAMES as FEATURES_ALL
from tacotron2_tpu_torch.preprocessing.table import (Rows, add_columns, column, concat,
                                                     read_table, write_table)

FEATURES_ALL_SPEAKER_NORM = [f"{x}_speaker_norm" for x in FEATURES_ALL]
FEATURES_ALL_SPEAKER_NORM_CLIP = [f"{x}_clip" for x in FEATURES_ALL_SPEAKER_NORM]
FEATURES_ALL_DATASET_NORM = [f"{x}_dataset_norm" for x in FEATURES_ALL]
FEATURES_ALL_DATASET_NORM_CLIP = [f"{x}_clip" for x in FEATURES_ALL_DATASET_NORM]
FEATURES_ALL_DATASET_GENDER_NORM = [f"{x}_dataset_gender_norm" for x in FEATURES_ALL]
FEATURES_ALL_DATASET_GENDER_NORM_CLIP = [f"{x}_clip" for x in FEATURES_ALL_DATASET_GENDER_NORM]

HIFI_GENDER = {92: "f", 6097: "m", 9017: "m"}  # the reference's hifi.py:18

Table = Tuple[List[str], Rows]


def normalize(x, medians, stds):
    """median +- 3 sigma -> [-1, 1], linearly."""
    minimums = medians - 3 * stds
    maximums = medians + 3 * stds
    return (((x - minimums) * 2.0) / (maximums - minimums)) + -1.0


def _features(rows: Rows) -> np.ndarray:
    return np.stack([column(rows, f) for f in FEATURES_ALL], axis=1).reshape(len(rows), -1)


def feature_stats(rows: Rows) -> Tuple[np.ndarray, np.ndarray]:
    """Per feature: the median and the standard deviation (ddof=1), NaN
    skipped; NaN where too few values."""
    x = _features(rows)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanmedian(x, axis=0), np.nanstd(x, axis=0, ddof=1)


def do_norm(table: Table, medians, stds, F: Sequence[str], F_CLIP: Sequence[str]) -> None:
    header, rows = table
    normed = normalize(_features(rows), medians, stds)
    clipped = np.clip(normed, -1, 1)
    for r, n, c in zip(rows, normed, clipped):
        r.update(zip(F, n.tolist()))
        r.update(zip(F_CLIP, c.tolist()))
    add_columns(header, [*F, *F_CLIP])


def _key(v):
    """A group key as pandas reads it: an int, else a float, else the string."""
    if isinstance(v, str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
    return v


def groupby(rows: Rows, by: str) -> Dict[object, Rows]:
    """Rows by the sorted values of column ``by``, each group in order."""
    groups: Dict[object, Rows] = {}
    for r in rows:
        groups.setdefault(_key(r[by]), []).append(r)
    return dict(sorted(groups.items()))


def do_norm_by(table: Table, train_rows: Rows, F, F_CLIP, by: str) -> Table:
    """Group-wise normalization with the train rows' statistics per group;
    -> a new table of copied rows, grouped by sorted key."""
    stats = {k: feature_stats(g) for k, g in groupby(train_rows, by).items()}
    header, parts = list(table[0]), []
    for key, group in groupby(table[1], by).items():
        part = (header, [dict(r) for r in group])
        do_norm(part, *stats[key], F, F_CLIP)
        parts += part[1]
    return header, parts


def train_test_split(rows: list, test_size: int, random_state: int) -> Tuple[list, list]:
    """scikit-learn's ``train_test_split`` with an integer test size."""
    n = len(rows)
    if not 0 < test_size < n:
        raise ValueError(f"test_size={test_size} should be positive and smaller than the "
                         f"number of samples {n}")
    p = np.random.RandomState(random_state).permutation(n)
    return [rows[i] for i in p[test_size:]], [rows[i] for i in p[:test_size]]


def _norm_all(train: Table, val: Table, test: Table) -> Tuple[Table, Table, Table]:
    """The dataset, speaker and dataset_gender families over the three
    splits, with the train split's statistics."""
    medians, stds = feature_stats(train[1])
    for d in (train, val, test):
        do_norm(d, medians, stds, FEATURES_ALL_DATASET_NORM, FEATURES_ALL_DATASET_NORM_CLIP)
    for F, F_CLIP, by in ((FEATURES_ALL_SPEAKER_NORM, FEATURES_ALL_SPEAKER_NORM_CLIP,
                           "speaker_id"),
                          (FEATURES_ALL_DATASET_GENDER_NORM,
                           FEATURES_ALL_DATASET_GENDER_NORM_CLIP, "gender")):
        train_rows = train[1]
        train, val, test = [do_norm_by(d, train_rows, F, F_CLIP, by) for d in (train, val, test)]
    return train, val, test


def split_ljspeech(csv_in, train_out, val_out, test_out, val_size=100, test_size=2000,
                   random_state=9001):
    header, rows = read_table(csv_in)
    train, test = train_test_split(rows, test_size, random_state)
    train, val = train_test_split(train, val_size, random_state)
    medians, stds = feature_stats(train)
    for d in (train, val, test):
        do_norm((header, d), medians, stds, FEATURES_ALL_SPEAKER_NORM,
                FEATURES_ALL_SPEAKER_NORM_CLIP)
    for rows_out, out in ((train, train_out), (val, val_out), (test, test_out)):
        write_table(out, header, rows_out)


def fix_sizes(train_split: Dict[object, Rows], rows: Rows, expected_size: int,
              random_state: int) -> Rows:
    """Each speaker's rows, followed by rows borrowed from that speaker's
    train rows until the speaker has ``expected_size``."""
    out: Rows = []
    for speaker_id, group in groupby(rows, "speaker_id").items():
        out += group
        diff = expected_size - len(group)
        if diff <= 0:
            continue
        remaining, borrowed = train_test_split(train_split[speaker_id], diff, random_state)
        train_split[speaker_id] = remaining
        out += borrowed
    return out


def split_hifi(train_in, val_in, test_in, train_out, val_out, test_out,
               speaker_val_size=100, speaker_test_size=2000, random_state=9001):
    tables = [read_table(p) for p in (train_in, val_in, test_in)]
    for header, rows in tables:
        for r in rows:
            r["gender"] = HIFI_GENDER[int(float(r["speaker_id_dataset"]))]
        add_columns(header, ["gender"])
    (h_train, train), (h_val, val), (h_test, test) = tables
    split = groupby(train, "speaker_id")
    val = fix_sizes(split, val, speaker_val_size, random_state)
    test = fix_sizes(split, test, speaker_test_size, random_state)
    train = [r for g in split.values() for r in g]
    outs = _norm_all((h_train, train), (h_val, val), (h_test, test))
    for (header, rows), out in zip(outs, (train_out, val_out, test_out)):
        write_table(out, header, rows)


def split_lj_hifi(hifi_train_in, hifi_val_in, hifi_test_in, lj_train_in, lj_val_in, lj_test_in,
                  train_out, val_out, test_out, hifi_dir="hi_fi_tts_v0", lj_dir="LJSpeech-1.1"):
    hifi = [read_table(p) for p in (hifi_train_in, hifi_val_in, hifi_test_in)]
    lj = [read_table(p) for p in (lj_train_in, lj_val_in, lj_test_in)]
    for _, rows in hifi:
        for r in rows:
            r["wav"] = path.join(hifi_dir, r["wav"])
    lj_speaker_id = max(_key(r["speaker_id"]) for r in hifi[0][1]) + 1
    for header, rows in lj:
        for r in rows:
            r["wav"] = path.join(lj_dir, r["wav"])
            r["gender"] = "f"  # LJ speaker annotation (lj-hifi.py:91-98)
            r["speaker_id"] = lj_speaker_id
        add_columns(header, ["gender", "speaker_id"])

    for split_name, h, l in (("val", hifi[1], lj[1]), ("test", hifi[2], lj[2])):
        for sid, g in groupby(h[1], "speaker_id").items():
            if len(g) < len(l[1]):
                raise ValueError(
                    f"Speaker {sid} in HiFi-TTS {split_name} has {len(g)} instances, "
                    f"fewer than LJSpeech's {len(l[1])}")

    outs = _norm_all(*(concat(h, l) for h, l in zip(hifi, lj)))
    for (header, rows), out in zip(outs, (train_out, val_out, test_out)):
        write_table(out, header, rows)


def index_libritts(libritts_dir, out_dir, durations_csv=None, max_duration=10.0,
                   sets=("dev-clean", "test-clean", "train-clean-100")):
    """Walk speaker/chapter dirs, keep clips up to ``max_duration`` (by the
    durations CSV: first column the clip's path, second its seconds), pair
    each wav with its ``.normalized.txt``; write one CSV a set
    (``wav|speaker_id|text_normalized``) and the sorted speaker ids."""
    durations = {}
    if durations_csv and path.exists(durations_csv):
        with open(durations_csv, newline="") as f:
            reader = csv.reader(f)
            next(reader, None)
            durations = {r[0]: float(r[1]) for r in reader if r}

    speaker_ids = set()
    for set_name in sets:
        rows = []
        set_dir = path.join(libritts_dir, set_name)
        if not path.isdir(set_dir):
            continue
        for speaker in sorted(os.listdir(set_dir)):
            sp_dir = path.join(set_dir, speaker)
            if not path.isdir(sp_dir):
                continue
            for chapter in sorted(os.listdir(sp_dir)):
                ch_dir = path.join(sp_dir, chapter)
                if not path.isdir(ch_dir):
                    continue
                for f in sorted(os.listdir(ch_dir)):
                    if not f.endswith(".wav"):
                        continue
                    rel = path.join(set_name, speaker, chapter, f)
                    if durations and durations.get(rel, 0.0) > max_duration:
                        continue
                    txt = path.join(ch_dir, f.replace(".wav", ".normalized.txt"))
                    if not path.exists(txt):
                        continue
                    with open(txt) as tf:
                        text = tf.read().strip()
                    rows.append((rel, speaker, text))
                    speaker_ids.add(speaker)
        out_path = path.join(out_dir, f"libritts-{set_name}.csv")
        with open(out_path, "w") as f:
            f.write("wav|speaker_id|text_normalized\n")
            for rel, speaker, text in rows:
                f.write(f"{rel}|{speaker}|{text}\n")
        print(f"{set_name}: {len(rows)} clips")
    with open(path.join(out_dir, "libritts-speaker-ids.csv"), "w") as f:
        for s in sorted(speaker_ids):
            f.write(f"{s}\n")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tacotron2_tpu_torch.preprocessing.splits")
    sub = p.add_subparsers(dest="command", required=True)
    lj = sub.add_parser("ljspeech")
    for name in ("--csv-in", "--train-out", "--val-out", "--test-out"):
        lj.add_argument(name, type=str, required=True)
    lj.add_argument("--val-size", type=int, default=100)
    lj.add_argument("--test-size", type=int, default=2000)
    lj.add_argument("--random_state", type=int, default=9001)

    hi = sub.add_parser("hifi")
    for name in ("--train-in", "--val-in", "--test-in", "--train-out", "--val-out",
                 "--test-out"):
        hi.add_argument(name, type=str, required=True)
    hi.add_argument("--speaker-val-size", type=int, default=100)
    hi.add_argument("--speaker-test-size", type=int, default=2000)
    hi.add_argument("--random_state", type=int, default=9001)

    lh = sub.add_parser("lj-hifi")
    for name in ("--hifi-train-in", "--hifi-val-in", "--hifi-test-in", "--lj-train-in",
                 "--lj-val-in", "--lj-test-in", "--train-out", "--val-out", "--test-out"):
        lh.add_argument(name, type=str, required=True)
    lh.add_argument("--hifi-dir", type=str, default="hi_fi_tts_v0")
    lh.add_argument("--lj-dir", type=str, default="LJSpeech-1.1")

    li = sub.add_parser("libritts-index")
    li.add_argument("--libritts-dir", type=str, required=True)
    li.add_argument("--out-dir", type=str, default=".")
    li.add_argument("--durations-csv", type=str, default=None)
    li.add_argument("--max-duration", type=float, default=10.0)
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    a = _parser().parse_args(argv)
    if a.command == "ljspeech":
        split_ljspeech(a.csv_in, a.train_out, a.val_out, a.test_out, a.val_size, a.test_size,
                       a.random_state)
    elif a.command == "hifi":
        split_hifi(a.train_in, a.val_in, a.test_in, a.train_out, a.val_out, a.test_out,
                   a.speaker_val_size, a.speaker_test_size, a.random_state)
    elif a.command == "lj-hifi":
        split_lj_hifi(a.hifi_train_in, a.hifi_val_in, a.hifi_test_in, a.lj_train_in,
                      a.lj_val_in, a.lj_test_in, a.train_out, a.val_out, a.test_out,
                      a.hifi_dir, a.lj_dir)
    else:
        index_libritts(a.libritts_dir, a.out_dir, a.durations_csv, a.max_duration)


if __name__ == "__main__":
    main()
