"""Tokenization for the port: the reversible byte-level tokenizer and the
batch helpers, copied from ``sentio_tpu/models/tokenizer.py``.

:class:`ByteTokenizer` — vocab = 256 bytes + specials, fully reversible;
``batch_encode`` right-pads a batch, ``batch_encode_pairs`` builds the
cross-encoder's ``[CLS] a [SEP] b [SEP]`` rows with type ids.
:class:`WordHashTokenizer` hashes words to ids;
:class:`HFTokenizer` reads a Hugging Face tokenizer directory without
``transformers`` (``models/hf_tokenizer.py`` runs its ``tokenizer.json``)
and encodes and decodes as the JAX package's ``HFTokenizer`` does through
``transformers``; :func:`get_tokenizer` picks one by kind.
"""

from __future__ import annotations

import hashlib
import random
from typing import Optional, Protocol, Sequence

import numpy as np

from sentio_tpu_torch.models.hf_tokenizer import cleanup_spaces, read_directory, special_id


class Tokenizer(Protocol):
    vocab_size: int
    pad_id: int
    bos_id: int
    eos_id: int
    cls_id: int
    sep_id: int

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]: ...
    def decode(self, ids: Sequence[int]) -> str: ...


def batch_encode(
    tokenizer: "Tokenizer",
    texts: Sequence[str],
    max_len: int,
    add_bos: bool = False,
    add_eos: bool = False,
    pad_to: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Encode + truncate + right-pad a batch. Returns (ids, mask) int32/bool
    arrays shaped [B, L] with L = pad_to or the longest row (<= max_len)."""
    rows = [tokenizer.encode(t, add_bos=add_bos, add_eos=add_eos)[:max_len] for t in texts]
    rows = [r if r else [tokenizer.pad_id] for r in rows]
    width = pad_to if pad_to is not None else max(len(r) for r in rows)
    width = max(min(width, max_len), 1)
    ids = np.full((len(rows), width), tokenizer.pad_id, dtype=np.int32)
    mask = np.zeros((len(rows), width), dtype=bool)
    for i, r in enumerate(rows):
        r = r[:width]
        ids[i, : len(r)] = r
        mask[i, : len(r)] = True
    return ids, mask


def batch_encode_pairs(
    tokenizer: "Tokenizer",
    pairs: Sequence[tuple[str, str]],
    max_len: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cross-encoder input: [CLS] a [SEP] b [SEP] with type ids 0/1.
    The first segment keeps at most half the budget; the doc gets the rest."""
    ids = np.full((len(pairs), max_len), tokenizer.pad_id, dtype=np.int32)
    mask = np.zeros((len(pairs), max_len), dtype=bool)
    types = np.zeros((len(pairs), max_len), dtype=np.int32)
    for i, (a, b) in enumerate(pairs):
        a_ids = tokenizer.encode(a)[: max_len // 2 - 2]
        b_budget = max_len - len(a_ids) - 3
        b_ids = tokenizer.encode(b)[: max(b_budget, 0)]
        row = [tokenizer.cls_id] + a_ids + [tokenizer.sep_id] + b_ids + [tokenizer.sep_id]
        row = row[:max_len]
        ids[i, : len(row)] = row
        mask[i, : len(row)] = True
        boundary = min(len(a_ids) + 2, max_len)
        types[i, boundary : len(row)] = 1
    return ids, mask, types


class ByteTokenizer:
    """UTF-8 bytes + 5 specials. ``decode(encode(s)) == s`` for any string."""

    def __init__(self, vocab_size: int = 512) -> None:
        if vocab_size < 261:
            raise ValueError("ByteTokenizer needs vocab_size >= 261")
        self.vocab_size = vocab_size
        self.pad_id, self.bos_id, self.eos_id, self.cls_id, self.sep_id = range(256, 261)

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """Bytes decode; specials are dropped, but UNUSED vocab slots (the
        MXU-alignment padding above the specials) render as the replacement
        char — a random-init model sampling them must yield visible output,
        not a silently empty string (which reads as 'no answer' downstream)."""
        out = bytearray()
        for i in ids:
            if 0 <= i < 256:
                out.append(i)
            elif i > self.sep_id:  # unused padded-vocab slot
                out.extend("�".encode())
        return out.decode("utf-8", errors="replace")


class WordHashTokenizer:
    """Stable word→id hash (md5). Irreversible; decode returns placeholder
    tokens."""

    def __init__(self, vocab_size: int = 512) -> None:
        if vocab_size < 16:
            raise ValueError("vocab too small")
        self.vocab_size = vocab_size
        self.pad_id, self.bos_id, self.eos_id, self.cls_id, self.sep_id = range(5)
        self._n_special = 8

    def _hash(self, word: str) -> int:
        h = int.from_bytes(hashlib.md5(word.encode()).digest()[:4], "little")
        return self._n_special + h % (self.vocab_size - self._n_special)

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = [self._hash(w) for w in text.lower().split()]
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        return " ".join(f"<{i}>" for i in ids if i >= self._n_special)


class HFTokenizer:
    """A local Hugging Face tokenizer directory, read with the standard
    library: ``vocab_size`` is the model's own vocabulary (added tokens
    excluded), the five special ids come from the directory's config
    through the vocabulary (0 for one it does not name), ``encode`` adds no
    special tokens of its own before ``add_bos`` / ``add_eos``, and
    ``decode`` skips special tokens and ids outside the vocabulary, then
    cleans up tokenization spaces when the config asks for it. ``rng``
    draws a BPE model's dropout (the tokenizer's own seeded one if None)."""

    def __init__(self, path: str, rng: Optional[random.Random] = None) -> None:
        self.path = str(path)
        self._tok, names, self._cleanup = read_directory(self.path, rng)
        self.vocab_size = self._tok.vocab_size
        self.pad_id = special_id(self._tok, names["pad_token"])
        self.bos_id = special_id(self._tok, names["bos_token"])
        self.eos_id = special_id(self._tok, names["eos_token"])
        self.cls_id = special_id(self._tok, names["cls_token"])
        self.sep_id = special_id(self._tok, names["sep_token"])

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> list[int]:
        ids = self._tok.encode(text)
        if add_bos:
            ids = [self.bos_id] + ids
        if add_eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = self._tok.decode([int(i) for i in ids], skip_special_tokens=True)
        return cleanup_spaces(text) if self._cleanup else text


def get_tokenizer(kind: str, vocab_size: int = 512, path: str = "") -> Tokenizer:
    if kind == "byte":
        return ByteTokenizer(vocab_size)
    if kind == "hash":
        return WordHashTokenizer(vocab_size)
    if kind == "hf":
        return HFTokenizer(path)
    raise ValueError(f"unknown tokenizer kind {kind!r}")
