"""Byte-level BPE tokenizer, id-for-id with CLIP's text tokenization.

Text cleanup is unicode NFC + double html-unescape + whitespace
collapse + lowercase; ``tokenize`` gives SOT + BPE ids + EOT,
zero-padded to ``context_length``. This is the port's own copy of
``mvlpt_tpu/tokenizer/bpe.py``, with three changes:

  * Standard-library ``re`` only. The word pattern's ``\\p{L}`` and
    ``\\p{N}`` classes are rebuilt as ``re`` character classes from the
    Unicode category of every code point (``unicodedata.category``
    starting with ``L`` or ``N``). On ASCII the split is identical by
    construction. Elsewhere it can differ only where Python's Unicode
    database and the ``regex`` package's disagree on a character's
    category, since each follows its own Unicode version.
  * No native fast path and no download function.
  * ``write_synthetic_vocab`` writes a merges file of the real file's
    size (a header plus 48,894 unique merges) built from pairs of
    byte-unicode symbols, so that hosts without the real
    ``bpe_simple_vocab_16e6.txt.gz`` can tokenize. Its ids are not
    CLIP's ids.

The vocab file is looked up in ``$MVLPT_TORCH_BPE_PATH``, then in the
cache directories and the package's ``assets`` folder.
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

BPE_VOCAB_FILENAME = "bpe_simple_vocab_16e6.txt.gz"
SOT_TEXT = "<|startoftext|>"
EOT_TEXT = "<|endoftext|>"
NUM_MERGES = 49152 - 256 - 2  # vocab 49408 = 256 bytes + 256 '</w>' + merges + 2 specials


def _search_paths() -> tuple[str, ...]:
    # Read at call time, so that setting MVLPT_TORCH_BPE_PATH after
    # import takes effect.
    return (
        os.environ.get("MVLPT_TORCH_BPE_PATH", ""),
        os.path.expanduser(f"~/.cache/mvlpt_torch/{BPE_VOCAB_FILENAME}"),
        os.path.expanduser(f"~/.cache/clip/{BPE_VOCAB_FILENAME}"),
        os.path.join(os.path.dirname(__file__), "assets", BPE_VOCAB_FILENAME),
    )


def find_bpe_vocab() -> str:
    for p in _search_paths():
        if p and os.path.isfile(p):
            return p
    raise FileNotFoundError(
        f"Cannot locate {BPE_VOCAB_FILENAME}. Set MVLPT_TORCH_BPE_PATH to the "
        "file, or to a synthetic merges file made by write_synthetic_vocab().")


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

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or find_bpe_vocab()
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


_DEFAULT: ClipBpeTokenizer | None = None


def get_tokenizer() -> ClipBpeTokenizer:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ClipBpeTokenizer()
    return _DEFAULT


def tokenize(texts, context_length: int = 77, truncate: bool = False) -> np.ndarray:
    """Tokenize string(s) into an int32 array of shape (N, context_length):
    SOT + BPE + EOT, zero-padded; raises on overflow unless ``truncate``
    (which keeps the EOT as the final token)."""
    if isinstance(texts, str):
        texts = [texts]
    tok = get_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for row, text in enumerate(texts):
        ids = [tok.sot_token] + tok.encode(text) + [tok.eot_token]
        if len(ids) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"Input {text!r} is too long for context length {context_length}"
                )
            ids = ids[:context_length]
            ids[-1] = tok.eot_token
        out[row, : len(ids)] = ids
    return out
