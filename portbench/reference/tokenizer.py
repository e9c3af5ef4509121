"""A frozen copy of the port's byte-level BPE tokenizer, for the
reference and for the benchmark's synthetic vocab.

Copied from ``mvlpt_torch/tokenizer/bpe.py`` without its native core and
its file search: the reference tokenizes the class prompts itself, from
the same merges file the program reads, and imports nothing of the
program. ``write_synthetic_vocab`` writes the merges file that stands in
for CLIP's ``bpe_simple_vocab_16e6.txt.gz`` (a header plus 48,894 unique
merges of byte-unicode symbols, fixed by its seed); its ids are not
CLIP's ids.
"""

from __future__ import annotations

import gzip
import html
import os
import re
import sys
import unicodedata
from functools import lru_cache

import numpy as np

SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
NUM_MERGES = 49152 - 256 - 2  # vocab 49408 = 256 bytes + 256 '</w>' + merges + 2 specials


@lru_cache()
def _byte_to_unicode() -> dict[int, str]:
    """GPT-2's reversible byte->printable-unicode-char table."""
    keep = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    chars = keep[:]
    extra = 0
    for b in range(256):
        if b not in keep:
            keep.append(b)
            chars.append(256 + extra)
            extra += 1
    return dict(zip(keep, (chr(c) for c in chars)))


def write_synthetic_vocab(path: str, seed: int = 0) -> str:
    """Write a gzip merges file with the real file's shape: one header
    line, then exactly ``NUM_MERGES`` unique merge lines.

    Each merge joins two byte-unicode symbols (the second one possibly
    word-final, ``</w>``), drawn in an order fixed by ``seed``; so every
    merged token is unique and the vocab has the real size, 49,408."""
    symbols = list(_byte_to_unicode().values())
    seconds = symbols + [s + "</w>" for s in symbols]
    order = np.random.RandomState(seed).permutation(
        len(symbols) * len(seconds))[:NUM_MERGES]
    lines = ["#version: synthetic seed=%d" % seed]
    for k in order.tolist():
        first, second = divmod(k, len(seconds))
        lines.append(f"{symbols[first]} {seconds[second]}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with gzip.open(tmp, "wt", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    os.replace(tmp, path)
    return path


@lru_cache()
def _category_class(major: str) -> str:
    """A ``re`` character-class body holding every code point whose
    Unicode general category starts with ``major`` (``L`` or ``N``)."""
    ranges = []
    start = prev = None
    for cp in range(sys.maxunicode + 1):
        if unicodedata.category(chr(cp))[0] == major:
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            ranges.append((start, prev))
            start = None
    if start is not None:
        ranges.append((start, prev))
    return "".join(
        re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in ranges)


@lru_cache()
def _word_pattern() -> re.Pattern:
    letters, numbers = _category_class("L"), _category_class("N")
    return re.compile(
        r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"""
        rf"""[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+""",
        re.IGNORECASE,
    )


_WS_PAT = re.compile(r"\s+")


def _clean_text(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    text = _WS_PAT.sub(" ", text)
    return text.strip()


class ClipBpeTokenizer:
    """Stateless-after-init BPE encoder/decoder over a CLIP merges file."""

    def __init__(self, bpe_path: str):
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            raw = f.read()
        lines = raw.split("\n")
        merge_lines = lines[1 : NUM_MERGES + 1]
        if len(merge_lines) != NUM_MERGES:
            raise ValueError(
                f"{bpe_path}: {len(merge_lines)} merge lines, want {NUM_MERGES}")
        merges = [tuple(line.split()) for line in merge_lines]

        self._byte_enc = _byte_to_unicode()
        self._byte_dec = {v: k for k, v in self._byte_enc.items()}

        base = list(self._byte_enc.values())
        vocab = base + [c + "</w>" for c in base]
        vocab.extend("".join(m) for m in merges)
        vocab.extend([SOT_TEXT, EOT_TEXT])

        self.encoder: dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        self.decoder: dict[int, str] = {i: tok for tok, i in self.encoder.items()}
        self._ranks: dict[tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self._cache: dict[str, str] = {SOT_TEXT: SOT_TEXT, EOT_TEXT: EOT_TEXT}
        self._word_pat = _word_pattern()

    @property
    def sot_token(self) -> int:
        return self.encoder[SOT_TEXT]

    @property
    def eot_token(self) -> int:
        return self.encoder[EOT_TEXT]

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    def _apply_bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        parts = list(token[:-1]) + [token[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            best = min(pairs, key=lambda p: self._ranks.get(p, float("inf")))
            if best not in self._ranks:
                break
            merged: list[str] = []
            i = 0
            while i < len(parts):
                if i < len(parts) - 1 and (parts[i], parts[i + 1]) == best:
                    merged.append(parts[i] + parts[i + 1])
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        out = " ".join(parts)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        text = _clean_text(text).lower()
        for word in self._word_pat.findall(text):
            word = "".join(self._byte_enc[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._apply_bpe(word).split(" "))
        return ids

    def decode(self, ids) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self._byte_dec[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")
