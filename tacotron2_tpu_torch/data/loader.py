"""Collate and a prefetching batch loader.

Counterpart of ``tacotron2_tpu/data/loader.py``. ``collate`` pads each batch
up to bucket multiples (chars -> 32, mel frames -> 128 in the train driver),
with zeros as the reference's ``pad_sequence``: padded gate targets are 0
against masked logits of -1000. The buckets keep the loss denominators
equal to the JAX package's on the same batch, and bound the number of
distinct decode lengths. ``TTSDataLoader`` builds items in a thread pool and
stages up to ``PREFETCH`` collated batches ahead of the consumer.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional

import numpy as np

PREFETCH = 2  # collated batches staged ahead of the consumer
WORKERS = min(8, 2 * (os.cpu_count() or 4))  # the reference's 8 loader workers, fewer on small hosts


def _round_up(x: int, m: Optional[int]) -> int:
    return -(-x // m) * m if m else x


def collate(items, bucket_chars: Optional[int] = None,
            bucket_frames: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Dataset items -> chars_idx (B, L), chars_len (B,), mel (B, T, M),
    mel_len (B,), gate (B, T, 1), and where the items' metadata have them
    speaker_id (B,) int64, controls (B, C) f32 (their ``features``) and
    description_embeddings (B, dim) f32;
    ``text`` and ``filename`` as lists where their third dicts have them."""
    data = [d for d, _, _ in items]
    meta = [m for _, m, _ in items]
    extra = [e for _, _, e in items]
    B = len(data)
    L = _round_up(max(len(d["chars_idx"]) for d in data), bucket_chars)
    T = _round_up(max(len(d["mel_spectrogram"]) for d in data), bucket_frames)
    M = data[0]["mel_spectrogram"].shape[1]
    batch = {"chars_idx": np.zeros((B, L), np.int64), "chars_len": np.zeros((B,), np.int64),
             "mel": np.zeros((B, T, M), np.float32), "mel_len": np.zeros((B,), np.int64),
             "gate": np.zeros((B, T, 1), np.float32)}
    for b, d in enumerate(data):
        n, t = len(d["chars_idx"]), len(d["mel_spectrogram"])
        batch["chars_idx"][b, :n] = d["chars_idx"]
        batch["mel"][b, :t] = d["mel_spectrogram"]
        batch["gate"][b, :t] = d["gate"]
        batch["chars_len"][b], batch["mel_len"][b] = n, t
    if "speaker_id" in meta[0]:
        batch["speaker_id"] = np.asarray([m["speaker_id"] for m in meta], np.int64)
    if "features" in meta[0]:
        batch["controls"] = np.stack([m["features"] for m in meta]).astype(np.float32)
    if "description_embeddings" in meta[0]:
        batch["description_embeddings"] = np.concatenate(
            [m["description_embeddings"] for m in meta], axis=0).astype(np.float32)
    for key in ("text", "filename"):
        if key in extra[0]:
            batch[key] = [e[key] for e in extra]
    return batch


class TTSDataLoader:
    """Iterable over collated batches of one epoch; a shuffled loader
    reshuffles each epoch from ``seed + epoch``."""

    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = True, seed: int = 0, bucket_chars: Optional[int] = None,
                 bucket_frames: Optional[int] = None):
        self.dataset, self.batch_size = dataset, batch_size
        self.shuffle, self.drop_last, self.seed = shuffle, drop_last, seed
        self.bucket_chars, self.bucket_frames = bucket_chars, bucket_frames
        self._epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _index_batches(self) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self._epoch).shuffle(idx)
        return [list(idx[i:i + self.batch_size]) for i in range(0, len(self) * self.batch_size,
                                                               self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._index_batches()
        self._epoch += 1
        out: "queue.Queue" = queue.Queue(maxsize=PREFETCH)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    out.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(max_workers=WORKERS) as pool:
                    for b in batches:
                        items = list(pool.map(self.dataset.__getitem__, b))
                        if not put(collate(items, self.bucket_chars, self.bucket_frames)):
                            return
                put(None)
            except Exception as e:  # the consumer re-raises it
                put(e)

        threading.Thread(target=produce, daemon=True).start()
        try:
            while True:
                batch = out.get()
                if batch is None:
                    return
                if isinstance(batch, Exception):
                    raise batch
                yield batch
        finally:
            stop.set()
