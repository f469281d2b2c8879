"""BERT's WordPiece tokenizer, read from a ``vocab.txt``.

Counterpart of the Hugging Face ``BertTokenizer`` that the JAX package's
``run/embed_descriptions.py::BertEmbedder`` tokenizes with, the same ids for
the same text, without ``transformers``:

1. with ``do_lower_case``, every character outside the special tokens is
   lowercased one at a time (``PreTrainedTokenizer.tokenize``);
2. the text is split at the special tokens ([CLS], [SEP], [PAD], [UNK],
   [MASK]), which stay whole;
3. each other piece goes through the basic tokenizer: drop NUL, U+FFFD and
   control characters, whitespace to " ", CJK ideographs into tokens of
   their own, NFC, split on whitespace; then per token lowercase and strip
   accents (NFD, the ``Mn`` marks dropped) when lowercasing, or strip them
   when ``strip_accents`` is set, and split off every punctuation character
   (ASCII 33-47, 58-64, 91-96, 123-126, and Unicode ``P*``);
4. greedy longest-match WordPiece with ``##`` continuations; a word of
   more than 100 characters, or one that no pieces cover, is [UNK].

``encode(text, max_length)`` adds [CLS] / [SEP] and keeps the first
``max_length - 2`` pieces, as ``encode(text, truncation=True,
max_length=...)`` does.
"""

from __future__ import annotations

import json
import os
import unicodedata
from typing import Dict, List, Optional

SPECIAL_TOKENS = ("[UNK]", "[SEP]", "[PAD]", "[CLS]", "[MASK]")
MAX_WORD_CHARS = 100


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(token: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", token)
                   if unicodedata.category(c) != "Mn")


def _split_punctuation(token: str) -> List[str]:
    out: List[str] = []
    new_word = True
    for ch in token:
        if _is_punctuation(ch):
            out.append(ch)
            new_word = True
        else:
            if new_word:
                out.append("")
            new_word = False
            out[-1] += ch
    return out


def load_vocab(path: str) -> Dict[str, int]:
    """One token a line, its id the line's index (a repeated token takes the
    later line's)."""
    with open(path, "r", encoding="utf-8") as f:
        return {line.rstrip("\n"): i for i, line in enumerate(f.readlines())}


class WordPiece:
    def __init__(self, vocab: Dict[str, int], do_lower_case: bool = True,
                 tokenize_chinese_chars: bool = True, strip_accents: Optional[bool] = None):
        missing = [t for t in SPECIAL_TOKENS if t not in vocab]
        if missing:
            raise ValueError(f"the WordPiece vocabulary lacks the special tokens {missing}")
        self.vocab = vocab
        self.do_lower_case = do_lower_case
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents
        self.unk_token_id = vocab["[UNK]"]
        self.cls_token_id = vocab["[CLS]"]
        self.sep_token_id = vocab["[SEP]"]
        self.pad_token_id = vocab["[PAD]"]
        self.mask_token_id = vocab["[MASK]"]
        self.all_special_ids = [vocab[t] for t in SPECIAL_TOKENS]

    @classmethod
    def from_dir(cls, directory: str) -> "WordPiece":
        """``vocab.txt`` of ``directory``, with the lowercasing, CJK and
        accent options of its ``tokenizer_config.json`` where it has one
        (``BertTokenizer``'s defaults otherwise)."""
        vocab = os.path.join(directory, "vocab.txt")
        if not os.path.exists(vocab):
            raise FileNotFoundError(f"WordPiece vocab not found at {vocab}: place the BERT "
                                    "vocab.txt next to its weights")
        opts = {}
        conf = os.path.join(directory, "tokenizer_config.json")
        if os.path.exists(conf):
            with open(conf) as f:
                raw = json.load(f)
            opts = {k: raw[k] for k in ("do_lower_case", "tokenize_chinese_chars",
                                        "strip_accents") if k in raw}
        return cls(load_vocab(vocab), **opts)

    # ------------------------------------------------------------------
    def _split_special(self, text: str) -> List[str]:
        """``text`` cut at the special tokens, which stay whole pieces."""
        pieces, start, i = [], 0, 0
        while i < len(text):
            hit = next((t for t in SPECIAL_TOKENS if text.startswith(t, i)), None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i += len(hit)
            start = i
        pieces.append(text[start:])
        return [p for p in pieces if p]

    def _basic(self, text: str) -> List[str]:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            if _is_whitespace(ch):
                chars.append(" ")
            elif self.tokenize_chinese_chars and _is_cjk(cp):
                chars.append(f" {ch} ")
            else:
                chars.append(ch)
        tokens = []
        for token in unicodedata.normalize("NFC", "".join(chars)).split():
            if self.do_lower_case:
                token = token.lower()
                if self.strip_accents is not False:
                    token = _strip_accents(token)
            elif self.strip_accents:
                token = _strip_accents(token)
            tokens += _split_punctuation(token)
        return " ".join(tokens).split()

    def _wordpiece(self, word: str) -> List[str]:
        if len(word) > MAX_WORD_CHARS:
            return ["[UNK]"]
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return ["[UNK]"]
            out.append(piece)
            start = end
        return out

    def tokenize(self, text: str) -> List[str]:
        if self.do_lower_case:
            text = "".join(self._lower_outside_specials(text))
        tokens = []
        for piece in self._split_special(text):
            if piece in SPECIAL_TOKENS:
                tokens.append(piece)
                continue
            for word in self._basic(piece):
                tokens += self._wordpiece(word)
        return tokens

    def _lower_outside_specials(self, text: str):
        i = 0
        while i < len(text):
            hit = next((t for t in SPECIAL_TOKENS if text.startswith(t, i)), None)
            if hit is not None:
                yield hit
                i += len(hit)
            else:
                yield text[i].lower()  # one character at a time, as HF's regex
                i += 1

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        """[CLS] ids [SEP], the ids cut to ``max_length`` with the two
        included."""
        ids = [self.vocab.get(t, self.unk_token_id) for t in self.tokenize(text)]
        if max_length is not None:
            ids = ids[:max(0, max_length - 2)]
        return [self.cls_token_id] + ids + [self.sep_token_id]
