"""SentencePiece's precompiled character map and the ``Precompiled``
normalizer, as ``tokenizers`` runs them.

The map (``precompiled_charsmap``, base64 in ``tokenizer.json``) is a
little-endian ``u32`` giving the trie's size in bytes, a darts-clone double
array of that many bytes of ``u32`` units, then the NUL-terminated
replacement strings. A unit holds a label in its low byte (bit 31 marks a
leaf, so a leaf never matches a byte), ``has_leaf`` in bit 8, an offset of
``(u >> 10) << ((u & 512) >> 6)`` and, in a leaf, a 31-bit value: the
replacement's byte offset.

The normalizer walks the text one extended grapheme cluster at a time
(:mod:`graphemes`). A cluster under 6 bytes is looked up whole: the
shortest key that is a prefix of it replaces the whole cluster. Otherwise,
or when nothing matches, each code point is looked up on its own and kept
when nothing matches. A key never matches across clusters.
"""

from __future__ import annotations

import base64
import binascii
import re
import struct
from typing import Optional

from sentio_tpu_torch.models import graphemes

_CACHE_LIMIT = 1 << 16


class CharsMap:
    """A precompiled character map: :meth:`normalize` is ``tokenizers``'
    ``Precompiled`` normalizer."""

    def __init__(self, blob: bytes, path: str = "tokenizer.json") -> None:
        if len(blob) < 4:
            raise ValueError(f"{path}: precompiled_charsmap of {len(blob)} bytes has no "
                             "trie size")
        (size,) = struct.unpack_from("<I", blob)
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"{path}: precompiled_charsmap's trie of {size} bytes does not "
                             f"fit its {len(blob)} bytes")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.strings = blob[4 + size:]
        try:
            self.strings.decode("utf-8")
        except UnicodeDecodeError as exc:
            raise ValueError(f"{path}: precompiled_charsmap's strings are not UTF-8") from exc
        self.path = path
        self._replacements: dict[int, str] = {}
        # code point -> 2 when it is a key, 1 when it only starts longer
        # keys, 0 when no key starts with it
        self._starts: dict[str, int] = {}
        self._clusters: dict[str, str] = {}

    @classmethod
    def from_base64(cls, text: str, path: str = "tokenizer.json") -> "CharsMap":
        try:
            blob = base64.b64decode(text, validate=True)
        except (binascii.Error, ValueError) as exc:
            raise ValueError(f"{path}: precompiled_charsmap is not base64") from exc
        return cls(blob, path)

    # ------------------------------------------------------------ the trie

    def _walk(self, key: bytes, first_leaf: bool) -> Optional[int]:
        """With ``first_leaf``, the value of the shortest key that is a
        prefix of ``key`` (``common_prefix_search``'s first result), else
        None; without it, 1 when ``key`` is a prefix of some key."""
        units = self.units
        n = len(units)
        if not n:
            return None
        u = units[0]
        pos = (u >> 10) << ((u & 512) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            if pos >= n:
                return None
            u = units[pos]
            if u & 0x800000FF != c:
                return None
            pos ^= (u >> 10) << ((u & 512) >> 6)
            if first_leaf and u & 256:
                return units[pos] & 0x7FFFFFFF if pos < n else None
        return None if first_leaf else 1

    def _replacement(self, value: int) -> str:
        text = self._replacements.get(value)
        if text is None:
            end = self.strings.find(b"\0", value)
            raw = self.strings[value: end if end >= 0 else len(self.strings)]
            try:
                text = raw.decode("utf-8")
            except UnicodeDecodeError as exc:
                raise ValueError(f"{self.path}: precompiled_charsmap value {value} does not "
                                 "start a UTF-8 string") from exc
            self._replacements[value] = text
        return text

    def transform(self, chunk: str) -> Optional[str]:
        """The replacement of the shortest key that is a prefix of
        ``chunk``, None when no key is."""
        value = self._walk(chunk.encode("utf-8"), True)
        return None if value is None else self._replacement(value)

    def _starts_key(self, c: str) -> int:
        kind = self._starts.get(c)
        if kind is None:
            key = c.encode("utf-8")
            kind = (2 if self._walk(key, True) is not None
                    else 1 if self._walk(key, False) is not None else 0)
            self._starts[c] = kind
        return kind

    # ---------------------------------------------------------- normalizer

    def _cluster(self, cluster: str) -> str:
        out = self._clusters.get(cluster)
        if out is not None:
            return out
        out = None
        if len(cluster.encode("utf-8")) < 6:
            out = self.transform(cluster)
        if out is None:
            parts = []
            for c in cluster:
                r = self.transform(c) if self._starts_key(c) else None
                parts.append(c if r is None else r)
            out = "".join(parts)
        if len(self._clusters) < _CACHE_LIMIT:
            self._clusters[cluster] = out
        return out

    def normalize(self, text: str) -> str:
        if not self._touched(text):
            return text
        return "".join(self._cluster(g) for g in graphemes.clusters(text))

    def _touched(self, text: str) -> bool:
        """Whether a key can match in ``text``. A key's first code point is
        one of the text's; an ASCII one that only starts longer keys
        matches only where its cluster goes on: before a non-ASCII
        character, or as the CR of CR LF (an ASCII character never joins
        the one before it)."""
        starters = [c for c in set(text) if self._starts_key(c)]
        if not starters:
            return False
        if any(c > "\x7f" or self._starts_key(c) == 2 for c in starters):
            return True
        if "\r" in starters and "\r\n" in text:
            return True
        return re.search(f"[{re.escape(''.join(starters))}][^\\x00-\\x7f]", text) is not None
