"""Speaker-ID label encoding.

Counterpart of ``tacotron2_tpu/utils/speaker_ids.py`` (the reference's
model/speaker_embeddings/utils.py: a memoized sklearn ``LabelEncoder`` over
a speaker-ID file), without sklearn.
"""

from __future__ import annotations

import functools
from typing import Dict, List


class SpeakerIdEncoder:
    """``LabelEncoder``'s semantics: the sorted unique ids -> 0..N-1."""

    def __init__(self, speaker_ids: List):
        self.classes_ = sorted(set(speaker_ids))
        self._index: Dict = {c: i for i, c in enumerate(self.classes_)}

    def transform(self, ids: List) -> List[int]:
        return [self._index[i] for i in ids]

    def inverse_transform(self, idx: List[int]):
        return [self.classes_[i] for i in idx]


@functools.lru_cache(maxsize=None)
def get_encoder(speaker_id_file: str) -> SpeakerIdEncoder:
    """The memoized encoder of a newline-separated speaker-ID file."""
    with open(speaker_id_file) as f:
        return SpeakerIdEncoder([line.strip() for line in f if line.strip()])
