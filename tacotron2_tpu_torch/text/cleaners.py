"""Text normalization frontend.

Mirrors the reference pipeline (datasets/tts_dataset.py:136-146 and the inline
re-implementation in run/say.py:43-60):

    unidecode -> lower -> strip chars outside allowed_chars -> [expand
    abbreviations] -> append end token

The reference depends on the ``unidecode`` package; we implement an
ASCII transliteration locally (NFKD decomposition + a table of Latin ligatures
and typographic punctuation), which covers TTS corpora (LJSpeech/HiFi-TTS/
LibriTTS are ASCII-dominant English). Abbreviation rules are the same 18
regexes (datasets/tts_dataset.py:19-47).
"""

from __future__ import annotations

import re
import unicodedata

# Latin ligatures / letters that NFKD does not decompose to ASCII, plus
# typographic punctuation. Mirrors unidecode's output for these codepoints.
_TRANSLIT_TABLE = {
    "Æ": "AE", "æ": "ae",            # Æ æ
    "Œ": "OE", "œ": "oe",            # Œ œ
    "ß": "ss",                              # ß
    "Ø": "O", "ø": "o",              # Ø ø
    "Đ": "D", "đ": "d",              # Đ đ
    "Ð": "D", "ð": "d",              # Ð ð
    "Þ": "Th", "þ": "th",            # Þ þ
    "Ł": "L", "ł": "l",              # Ł ł
    "ı": "i",                               # ı
    "‘": "'", "’": "'", "‚": "'", "‛": "'",
    "“": '"', "”": '"', "„": '"',
    "–": "-", "—": "--", "―": "--", "−": "-",
    "…": "...",
    " ": " ", " ": " ", " ": " ", " ": " ", " ": " ",
    "«": '"', "»": '"', "‹": "'", "›": "'",
    "·": "*", "•": "*",
    "¼": " 1/4", "½": " 1/2", "¾": " 3/4",
    "©": "(c)", "®": "(r)", "™": "(tm)",
    "°": "deg", "£": "PS", "€": "EU",
}


def ascii_transliterate(text: str) -> str:
    """Best-effort Unicode -> ASCII transliteration (unidecode equivalent)."""
    out = []
    for ch in text:
        if ord(ch) < 128:
            out.append(ch)
            continue
        if ch in _TRANSLIT_TABLE:
            out.append(_TRANSLIT_TABLE[ch])
            continue
        decomposed = unicodedata.normalize("NFKD", ch)
        ascii_part = "".join(c for c in decomposed if ord(c) < 128 and not unicodedata.combining(c))
        out.append(ascii_part)  # non-representable chars drop, like unidecode's '' cases
    return "".join(out)


# The reference's 18 abbreviation rules (datasets/tts_dataset.py:19-43).
_ABBREVIATIONS = [
    (re.compile(r"\b%s\." % x[0], re.IGNORECASE), x[1])
    for x in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]


def expand_abbreviations(text: str) -> str:
    for regex, replacement in _ABBREVIATIONS:
        text = re.sub(regex, replacement, text)
    return text


def normalize_text(
    text: str,
    allowed_chars: str,
    end_token: str | None = None,
    do_expand_abbreviations: bool = False,
) -> str:
    """Full normalization pipeline; order matches the reference
    (transliterate -> lower -> strip -> expand -> end token,
    datasets/tts_dataset.py:136-146)."""
    allowed_re = re.compile(f"[^{allowed_chars}]+")
    text = allowed_re.sub("", ascii_transliterate(text).lower())
    if do_expand_abbreviations:
        text = expand_abbreviations(text)
    if end_token is not None:
        text = text + end_token
    return text
