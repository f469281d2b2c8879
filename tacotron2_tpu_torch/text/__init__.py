from tacotron2_tpu_torch.text.cleaners import (
    ascii_transliterate,
    expand_abbreviations,
    normalize_text,
)
from tacotron2_tpu_torch.text.encoder import CharEncoder

__all__ = [
    "ascii_transliterate",
    "expand_abbreviations",
    "normalize_text",
    "CharEncoder",
]
