"""Character -> integer-index encoding.

The reference uses sklearn's ``OrdinalEncoder`` fit on the sorted(!) unique
characters of ``allowed_chars (+ end_token)`` (datasets/tts_dataset.py:157-163,
run/say.py:46-50) and then adds 1 so index 0 is reserved for padding. sklearn's
OrdinalEncoder assigns indices by *sorted order* of the categories, not
insertion order — we reproduce exactly that so converted checkpoints keep
their embedding-row meaning.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


class CharEncoder:
    def __init__(self, allowed_chars: str, end_token: Optional[str] = None):
        if end_token is not None and end_token in allowed_chars:
            raise ValueError("end_token cannot be in allowed_chars!")
        vocab = list(allowed_chars) + ([end_token] if end_token is not None else [])
        # sklearn OrdinalEncoder sorts categories lexicographically
        self._sorted_vocab = sorted(set(vocab))
        if len(self._sorted_vocab) != len(vocab):
            raise ValueError("allowed_chars contains duplicate characters")
        # char -> ordinal + 1 (0 = padding, datasets/tts_dataset.py:224-225)
        self._char_to_idx = {c: i + 1 for i, c in enumerate(self._sorted_vocab)}
        self._idx_to_char = {i + 1: c for i, c in enumerate(self._sorted_vocab)}

    @property
    def vocab_size(self) -> int:
        """Number of real characters (excluding padding index 0)."""
        return len(self._sorted_vocab)

    def encode(self, text: str) -> np.ndarray:
        """Text -> int64 index array (padding-shifted, like the reference)."""
        try:
            return np.asarray([self._char_to_idx[c] for c in text], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"Character {e.args[0]!r} not in allowed_chars") from None

    def decode(self, idx: Sequence[int]) -> str:
        return "".join(self._idx_to_char[int(i)] for i in idx if int(i) != 0)

    def encode_batch(self, texts: List[str]) -> tuple[np.ndarray, np.ndarray]:
        """Pad-collate a batch of texts -> (indices (B, Lmax) int64, lengths (B,) int64)."""
        lengths = np.asarray([len(t) for t in texts], dtype=np.int64)
        max_len = int(lengths.max()) if len(texts) else 0
        out = np.zeros((len(texts), max_len), dtype=np.int64)
        for i, t in enumerate(texts):
            out[i, : len(t)] = self.encode(t)
        return out, lengths
