"""``embed_descriptions``: BERT pooler embeddings of a manifest's style
descriptions, in the layout training reads.

Counterpart of ``run/embed_descriptions.py`` of the JAX package
(``BertEmbedder``, ``do_embed_descriptions``): for every row with a
non-blank ``description``, the pooler output of the port's BERT
(``models/bert.py``, on the card unless asked for the CPU) over its
WordPiece ids (``text/wordpiece.py``), written as

    <speech_dir>/description_embeddings/<stem>.npy              (1, H)
    <speech_dir>/description_embeddings/<stem>_augmentations/aug{k}.npy

and a manifest copy with the ``description_embedding`` column filled (an
empty field where the description is blank: the dataset reads zeros
there). An augmentation re-encodes the text with each non-special token
replaced by [MASK] with probability ``augment_drop_prob``, drawn from a
``numpy.random.Generator`` in JAX's order (one ``random()`` per non-special
token, rows in order), so one seed gives JAX's masks. The ids of a batch
are padded to a multiple of 16 (JAX's ``_pad_to``).

The weights are local files only (``convert.load_bert``): a name that is not
a local path raises, where JAX would download it.
"""

from __future__ import annotations

import os
from os import path
from typing import List, Optional

import numpy as np
import torch

from tacotron2_tpu_torch.convert import load_bert
from tacotron2_tpu_torch.models.layers import resolve_device, use_f32_math
from tacotron2_tpu_torch.preprocessing.table import read_table, write_table

PAD_BUCKET = 16
# the strings pandas' read_csv reads as NaN: such a description is blank
PANDAS_NA = frozenset(("", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
                       "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
                       "nan", "null"))


def pad_ids(seqs: List[List[int]], bucket: int = PAD_BUCKET):
    """-> ids (N, L) int64 and mask (N, L) f32, L the longest row rounded
    up to ``bucket``; padding is id 0 with mask 0."""
    L = -(-max(len(s) for s in seqs) // bucket) * bucket
    ids = np.zeros((len(seqs), L), np.int64)
    mask = np.zeros((len(seqs), L), np.float32)
    for i, s in enumerate(seqs):
        ids[i, :len(s)] = s
        mask[i, :len(s)] = 1.0
    return ids, mask


class BertEmbedder:
    """Tokenize on the host, encode with the port's BERT on ``device``,
    return pooler_output rows."""

    def __init__(self, model, tokenizer, device: Optional[str] = None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            use_f32_math()
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        self.tokenizer = tokenizer

    @classmethod
    def from_local(cls, checkpoint: str, device: Optional[str] = None) -> "BertEmbedder":
        """An HF-layout directory or a state-dict file with ``vocab.txt``
        beside it (``convert.load_bert``)."""
        return cls(*load_bert(checkpoint), device=device)

    def embed(self, texts: List[str], drop_prob: float = 0.0,
              rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """-> (N, hidden) f32 pooler outputs. ``drop_prob`` > 0: each
        non-special token becomes [MASK] with that probability (``rng``)."""
        enc = [self.tokenizer.encode(t, self.cfg.max_position_embeddings) for t in texts]
        if drop_prob > 0.0:
            if rng is None:
                raise ValueError("augmentation needs a numpy Generator (rng)")
            mask_id, special = self.tokenizer.mask_token_id, set(self.tokenizer.all_special_ids)
            enc = [[mask_id if (tok not in special and rng.random() < drop_prob) else tok
                    for tok in s] for s in enc]
        ids, mask = pad_ids(enc)
        with torch.no_grad():
            _, pooled = self.model(torch.as_tensor(ids, device=self.device),
                                   torch.as_tensor(mask, device=self.device))
        return pooled.float().cpu().numpy()


def do_embed_descriptions(csv_path: str, speech_dir: str, out_csv: Optional[str] = None,
                          column: str = "description", out_column: str = "description_embedding",
                          bert: Optional[str] = None, augmentations: int = 0,
                          augment_drop_prob: float = 0.15, batch_size: int = 32, seed: int = 0,
                          embedder: Optional[BertEmbedder] = None,
                          device: Optional[str] = None) -> str:
    """-> the path of the manifest copy with ``out_column`` filled (default
    ``<csv>-embedded.csv``). ``bert``: local weights (``BertEmbedder.from_local``),
    unless ``embedder`` is given."""
    header, rows = read_table(csv_path)
    if column not in header:
        raise ValueError(f"column {column!r} not in {csv_path}")
    if embedder is None:
        if bert is None:
            raise ValueError("embed_descriptions needs --bert: a local BERT directory or "
                             "state-dict file")
        embedder = BertEmbedder.from_local(bert, device)
    out_dir = path.join(speech_dir, "description_embeddings")
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    rel_paths: List[str] = [""] * len(rows)
    todo = [(i, r[column]) for i, r in enumerate(rows)
            if r[column] not in PANDAS_NA and r[column].strip()]
    print(f"embed_descriptions: {len(todo)}/{len(rows)} rows have descriptions")
    for start in range(0, len(todo), batch_size):
        chunk = todo[start:start + batch_size]
        texts = [t for _, t in chunk]
        base = embedder.embed(texts)
        augs = [embedder.embed(texts, augment_drop_prob, rng) for _ in range(augmentations)]
        for j, (i, _) in enumerate(chunk):
            stem = path.splitext(path.basename(rows[i]["wav"]))[0]
            rel = path.join("description_embeddings", f"{stem}.npy")
            np.save(path.join(speech_dir, rel), base[j:j + 1])
            if augmentations:
                aug_dir = path.join(out_dir, f"{stem}_augmentations")
                os.makedirs(aug_dir, exist_ok=True)
                for k, a in enumerate(augs):
                    np.save(path.join(aug_dir, f"aug{k}.npy"), a[j:j + 1])
            rel_paths[i] = rel
    for r, p in zip(rows, rel_paths):
        r[out_column] = p
    if out_column not in header:
        header = header + [out_column]
    out_csv = out_csv or csv_path.replace(".csv", "-embedded.csv")
    write_table(out_csv, header, rows)
    print(f"wrote {out_csv}")
    return out_csv
