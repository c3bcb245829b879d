"""A Hugging Face tokenizer directory read with the standard library.

The JAX package tokenizes a checkpoint's text through ``transformers``
(``sentio_tpu/models/tokenizer.py::HFTokenizer``); the card's machine has
neither ``transformers`` nor ``tokenizers``, so this module runs the
``tokenizer.json`` pipeline itself, as the ``tokenizers`` library runs it:

1. added tokens are matched on the raw text (leftmost-longest, honouring
   their ``single_word``, ``lstrip`` and ``rstrip`` flags), those marked
   ``normalized`` on each normalized piece after it;
2. the normalizer, the pre-tokenizer and the model run on every piece
   left between them.

Every component ``tokenizers`` 0.22 defines is read:

==========  ==============================================================
normalizer  ``Sequence``, ``Prepend``, ``Replace``, ``BertNormalizer``,
            ``Precompiled`` (:mod:`charsmap`), ``Nmt``, ``NFC``, ``NFD``,
            ``NFKC``, ``NFKD``, ``Lowercase``, ``Strip``,
            ``StripAccents``, ``ByteLevel``
pre-tok.    ``Sequence``, ``Split``, ``ByteLevel`` (GPT-2's regex with
            ``use_regex``), ``BertPreTokenizer``, ``Metaspace``,
            ``Whitespace``, ``WhitespaceSplit``, ``CharDelimiterSplit``,
            ``Punctuation``, ``Digits``, ``UnicodeScripts``,
            ``FixedLength``
model       ``WordLevel``, ``BPE`` (byte fallback, ``fuse_unk``,
            ``ignore_merges``, ``continuing_subword_prefix``,
            ``end_of_word_suffix``, ``dropout`` drawn from the caller's
            ``random.Random``), ``WordPiece``, ``Unigram`` (byte
            fallback)
decoder     ``Sequence``, ``Fuse``, ``ByteLevel``, ``Replace``,
            ``ByteFallback``, ``Strip``, ``WordPiece``, ``Metaspace``,
            ``BPEDecoder``, ``CTC``
==========  ==============================================================

A component of any other ``type`` raises :class:`ValueError` naming it and
the file; there is no fallback. The post-processor and the truncation and padding
settings are read by nothing: ``encode`` adds no special tokens and
truncates nothing, as ``transformers``' ``encode(add_special_tokens=
False)`` does. Regular expressions are written for Oniguruma; the
``\\p{..}``, ``\\s`` and ``\\w`` classes they use are rebuilt from
``unicodedata`` and :mod:`unicode_tables` for Python's ``re``.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import json
import random
import re
import unicodedata
from pathlib import Path
from typing import Callable, Iterable, Optional

from sentio_tpu_torch.models import charsmap, unicode_tables
from sentio_tpu_torch.models import unicode_drift as drift

# Unicode's White_Space property: Rust's ``char::is_whitespace`` and
# Oniguruma's ``\s``
WHITE_SPACE = frozenset("\t\n\x0b\x0c\r \x85\xa0     　"
                        + "".join(chr(c) for c in range(0x2000, 0x200B)))
_NEWER_FORMAT = drift.range_chars(drift.NEWER_FORMAT)
_STRIP_KEEP = drift.range_chars(drift.STRIP_KEEP)
_STRIP_DROP = drift.range_chars(drift.STRIP_DROP)
_NFKC_KEEP = drift.range_chars(drift.NFKC_KEEP)
_NFD_KEEP = drift.range_chars(drift.NFD_KEEP)
_MARK_KEEP = drift.range_chars(drift.MARK_KEEP)
_MARK_DROP = drift.range_chars(drift.MARK_DROP)
_RUST_NUMERIC = drift.range_chars(drift.RUST_NUMERIC)
_PUNCT_ADD = drift.range_chars(drift.PUNCT_ADD)
_PUNCT_DROP = drift.range_chars(drift.PUNCT_DROP)
_LOWER = {chr(c): chr(c + r[2]) for r in drift.LOWER_DELTA for c in range(r[0], r[1] + 1)}
# Oniguruma's \p{L} and \p{N} beyond Python's tables
_ONIG_EXTRA = {"L": drift.ONIG_L, "N": drift.ONIG_N}


def _refuse(kind: str, spec, path: str) -> ValueError:
    name = spec.get("type") if isinstance(spec, dict) else spec
    return ValueError(f"{path}: {kind} {name!r} is not supported (the port reads the "
                      "tokenizer.json components listed in models/hf_tokenizer.py)")


# ------------------------------------------------------------ unicode classes


@functools.lru_cache(maxsize=None)
def _category_runs() -> tuple[tuple[int, int, str], ...]:
    """(first, last, category) of every run of code points that share a
    general category."""
    runs, start, cat = [], 0, unicodedata.category("\x00")
    for cp in range(1, 0x110000):
        c = unicodedata.category(chr(cp))
        if c != cat:
            runs.append((start, cp - 1, cat))
            start, cat = cp, c
    runs.append((start, 0x10FFFF, cat))
    return tuple(runs)


@functools.lru_cache(maxsize=None)
def _class_body(cats: tuple[str, ...]) -> str:
    """A ``re`` character-class body of every code point whose general
    category starts with one of ``cats`` (with Oniguruma's newer letters
    and numbers for ``L`` and ``N``), as ranges."""
    ranges = [(a, b) for a, b, c in _category_runs() if c.startswith(cats)]
    ranges += [r for c in cats for r in _ONIG_EXTRA.get(c, ())]
    return "".join(_class_char(a) if a == b else f"{_class_char(a)}-{_class_char(b)}"
                   for a, b in ranges)


def _class_char(cp: int) -> str:
    return f"\\U{cp:08x}"


_WS_BODY = "".join(_class_char(ord(c)) for c in sorted(WHITE_SPACE))
# the general categories a ``\p{..}`` may name, by their short names
_CATEGORY_NAMES = {"L", "Lu", "Ll", "Lt", "Lm", "Lo", "M", "Mn", "Mc", "Me", "N", "Nd",
                   "Nl", "No", "P", "Pc", "Pd", "Ps", "Pe", "Pi", "Pf", "Po", "S", "Sm",
                   "Sc", "Sk", "So", "Z", "Zs", "Zl", "Zp"}


@functools.lru_cache(maxsize=None)
def _word_body() -> str:
    """Oniguruma's ``\\w`` (:func:`unicode_tables.word_ranges`) as a class
    body."""
    return "".join(_class_char(a) if a == b else f"{_class_char(a)}-{_class_char(b)}"
                   for a, b in unicode_tables.word_ranges())


def _escape_body(esc: str, name: str, path: str) -> tuple[str, bool]:
    """(class body, negated) of an Oniguruma class escape."""
    if esc in "sS":
        return _WS_BODY, esc == "S"
    if esc in "wW":
        return _word_body(), esc == "W"
    if name not in _CATEGORY_NAMES:
        raise ValueError(f"{path}: regex class \\{esc}{{{name}}} is not supported")
    return _class_body((name,)), esc == "P"


def _read_escape(pattern: str, i: int) -> tuple[str, str, int]:
    """(escape letter, property name, length) of the escape at ``i``."""
    esc = pattern[i + 1]
    if esc in "pP" and pattern[i + 2: i + 3] == "{":
        end = pattern.index("}", i)
        return esc, pattern[i + 3: end], end - i + 1
    return esc, "", 2


def _class(pattern: str, i: int, path: str) -> tuple[str, int]:
    """The ``re`` form of the class ``[...]`` opening at ``i``, and the
    index after it. A negated escape inside (``[^\\S]``, ``[\\P{L}]``) makes
    the class a union with the escape's complement: ``(?:[pos]|[^neg])``,
    or for ``[^...]`` the intersection ``(?![pos])(?=[neg1])[neg2]``."""
    j = i + 1
    negated = pattern[j: j + 1] == "^"
    j += negated
    pos: list[str] = []
    negs: list[str] = []
    if pattern[j: j + 1] == "]":  # a leading ']' is a literal
        pos.append("\\]")
        j += 1
    while j < len(pattern) and pattern[j] != "]":
        ch = pattern[j]
        if ch == "\\" and j + 1 < len(pattern):
            esc, name, step = _read_escape(pattern, j)
            if esc in "pPsSwW":
                body, neg = _escape_body(esc, name, path)
                (negs if neg else pos).append(body)
            else:
                pos.append(pattern[j: j + step])
            j += step
            continue
        if ch == "[":
            raise ValueError(f"{path}: nested class in {pattern!r} is not supported")
        pos.append(ch)
        j += 1
    if j >= len(pattern):
        raise ValueError(f"{path}: unterminated class in {pattern!r}")
    body = "".join(pos)
    if not negs:
        return f"[{'^' if negated else ''}{body}]", j + 1
    if not negated:
        alts = ([f"[{body}]"] if body else []) + [f"[^{n}]" for n in negs]
        return f"(?:{'|'.join(alts)})", j + 1
    ahead = (f"(?![{body}])" if body else "") + "".join(f"(?=[{n}])" for n in negs[:-1])
    return f"(?:{ahead}[{negs[-1]}])", j + 1


def onig_to_re(pattern: str, path: str = "tokenizer.json") -> re.Pattern:
    """Compile an Oniguruma pattern of the kind ``tokenizer.json`` holds
    for Python's ``re``: ``\\p{X}``, ``\\P{X}``, ``\\s``, ``\\S``, ``\\w`` and
    ``\\W`` take Oniguruma's Unicode meanings, inside a class too;
    everything else passes through."""
    out, i = [], 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "\\" and i + 1 < len(pattern):
            esc, name, step = _read_escape(pattern, i)
            if esc in "pPsSwW":
                body, negated = _escape_body(esc, name, path)
                out.append(f"[{'^' if negated else ''}{body}]")
            else:
                out.append(pattern[i: i + step])
            i += step
            continue
        if ch == "[":
            text, i = _class(pattern, i, path)
            out.append(text)
            continue
        out.append(ch)
        i += 1
    return re.compile("".join(out))


# -------------------------------------------------------------- splitting

# a piece of text on its way through the pipeline: (text, starts the input)
Piece = tuple[str, bool]


def _regex_matches(text: str, regex: re.Pattern) -> list[tuple[int, int, bool]]:
    spans, prev = [], 0
    for m in regex.finditer(text):
        if m.start() == m.end():
            continue
        if prev != m.start():
            spans.append((prev, m.start(), False))
        spans.append((m.start(), m.end(), True))
        prev = m.end()
    if prev != len(text):
        spans.append((prev, len(text), False))
    return spans


def _char_matches(text: str, pred: Callable[[str], bool]) -> list[tuple[int, int, bool]]:
    spans, last = [], 0
    for i, c in enumerate(text):
        if pred(c):
            if last < i:
                spans.append((last, i, False))
            spans.append((i, i + 1, True))
            last = i + 1
    if last < len(text):
        spans.append((last, len(text), False))
    return spans


def _split(piece: Piece, spans: list[tuple[int, int, bool]], behavior: str) -> list[Piece]:
    """``NormalizedString::split``: the matches merged by ``behavior``,
    empty pieces dropped; the first piece keeps its "starts the input"
    mark."""
    text, first = piece
    if behavior == "Isolated":
        keep = [(a, b) for a, b, _ in spans]
    elif behavior == "Removed":
        keep = [(a, b) for a, b, hit in spans if not hit]
    elif behavior == "MergedWithNext":
        keep, prev = [], False
        for a, b, hit in reversed(spans):
            if hit and not prev and keep:
                keep[-1] = (a, keep[-1][1])
            else:
                keep.append((a, b))
            prev = hit
        keep.reverse()
    elif behavior == "MergedWithPrevious":
        keep, prev = [], False
        for a, b, hit in spans:
            if hit and not prev and keep:
                keep[-1] = (keep[-1][0], b)
            else:
                keep.append((a, b))
            prev = hit
    elif behavior == "Contiguous":
        keep, prev = [], False
        for a, b, hit in spans:
            if hit == prev and keep:
                keep[-1] = (keep[-1][0], b)
            else:
                keep.append((a, b))
            prev = hit
    else:
        raise ValueError(f"split behavior {behavior!r} is not supported")
    return [(text[a:b], first and a == 0) for a, b in keep if b > a]


# ----------------------------------------------------------- normalizers


def _normalize_run(form: str, text: str) -> str:
    out = unicodedata.normalize(form, text)
    if form in ("NFC", "NFKC") and any(c in _NFD_KEEP for c in out):
        # a pair the library's older tables do not compose stays apart
        out = "".join(unicodedata.normalize("NFD", c) if c in _NFD_KEEP else c for c in out)
    return out


def _normalize_except(form: str, text: str, keep: frozenset) -> str:
    """``unicodedata.normalize`` that leaves the characters in ``keep``
    (those ``tokenizers``' older tables do not map) as they are."""
    if not any(c in keep for c in text):
        return _normalize_run(form, text)
    out, run = [], []
    for c in text:
        if c in keep:
            out.append(_normalize_run(form, "".join(run)))
            out.append(c)
            run = []
        else:
            run.append(c)
    out.append(_normalize_run(form, "".join(run)))
    return "".join(out)


# the unicode forms and the characters each leaves as it is
_FORM_KEEP = {"NFC": _NFD_KEEP, "NFD": _NFD_KEEP, "NFKC": _NFKC_KEEP | _NFD_KEEP,
              "NFKD": _NFKC_KEEP | _NFD_KEEP}
# ``Nmt``: ASCII and C1 controls dropped, other spaces made ' '
_NMT_TABLE = str.maketrans(
    {**{c: None for c in (*range(0x1, 0x9), 0xB, *range(0xE, 0x20), 0x7F, 0x8F, 0x9F)},
     **{c: " " for c in (0x9, 0xA, 0xC, 0xD, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029,
                         0x2581, 0xFEFF, 0xFFFD)}})
_WS_CHARS = "".join(sorted(WHITE_SPACE))


def _lowercase(text: str) -> str:
    """Rust's ``char::to_lowercase`` of each character (no final-sigma
    context)."""
    return "".join(_LOWER.get(c) or c.lower() for c in text)


def _is_mark(c: str) -> bool:
    """``StripAccents``' combining mark."""
    if c in _MARK_DROP:
        return True
    return unicodedata.category(c)[0] == "M" and c not in _MARK_KEEP


def _bert_normalizer(spec: dict) -> Callable[[str], str]:
    clean, chinese = spec.get("clean_text", True), spec.get("handle_chinese_chars", True)
    lower = spec.get("lowercase", True)
    strip = spec.get("strip_accents")
    strip = lower if strip is None else strip

    def norm(text: str) -> str:
        if clean:
            text = "".join(
                " " if c in WHITE_SPACE else c for c in text
                if not (c == "\x00" or c == "�" or (
                    c not in "\t\n\r" and unicodedata.category(c) in ("Cc", "Cf", "Co", "Cs")
                    and c not in _NEWER_FORMAT)))
        if chinese:
            text = "".join(f" {c} " if _is_chinese(c) else c for c in text)
        if strip:
            text = "".join(c for c in _normalize_except("NFD", text, _STRIP_KEEP)
                           if not ((unicodedata.category(c) == "Mn" and c not in _STRIP_KEEP)
                                   or c in _STRIP_DROP))
        if lower:
            text = _lowercase(text)
        return text

    return norm


def _is_chinese(c: str) -> bool:
    cp = ord(c)
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B920 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def _replacer(spec: dict, path: str) -> Callable[[str], str]:
    pattern, content = spec["pattern"], spec["content"]
    if "String" in pattern:
        literal = pattern["String"]
        return lambda text: text.replace(literal, content)
    regex = onig_to_re(pattern["Regex"], path)
    return lambda text: regex.sub(lambda _m: content, text)


def build_normalizer(spec: Optional[dict], path: str) -> Callable[[str], str]:
    if spec is None:
        return lambda text: text
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_normalizer(s, path) for s in spec["normalizers"]]

        def run(text: str) -> str:
            for step in steps:
                text = step(text)
            return text

        return run
    if kind == "Prepend":
        prefix = spec["prepend"]
        return lambda text: prefix + text if text else text
    if kind == "Replace":
        return _replacer(spec, path)
    if kind == "BertNormalizer":
        return _bert_normalizer(spec)
    if kind in _FORM_KEEP:
        return functools.partial(_normalize_except, kind, keep=_FORM_KEEP[kind])
    if kind == "Precompiled":
        return charsmap.CharsMap.from_base64(spec.get("precompiled_charsmap") or "",
                                             path).normalize
    if kind == "Nmt":
        return lambda text: text.translate(_NMT_TABLE)
    if kind == "Lowercase":
        return _lowercase
    if kind == "Strip":
        left, right = spec.get("strip_left", True), spec.get("strip_right", True)

        def strip(text: str) -> str:
            if left:
                text = text.lstrip(_WS_CHARS)
            return text.rstrip(_WS_CHARS) if right else text

        return strip
    if kind == "StripAccents":
        return lambda text: "".join(c for c in text if not _is_mark(c))
    if kind == "ByteLevel":
        table = byte_to_unicode()
        return lambda text: "".join(table[b] for b in text.encode("utf-8"))
    raise _refuse("normalizer", spec, path)


# -------------------------------------------------------- pre-tokenizers


@functools.lru_cache(maxsize=None)
def byte_to_unicode() -> dict[int, str]:
    """GPT-2's printable stand-in for every byte."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_bert_punct(c: str) -> bool:
    if c in _PUNCT_ADD:
        return True
    return ((c.isascii() and not c.isalnum() and c.isprintable() and c != " ")
            or unicodedata.category(c).startswith("P")) and c not in _PUNCT_DROP


def _is_numeric(c: str) -> bool:
    """Rust's ``char::is_numeric``."""
    return unicodedata.category(c)[0] == "N" or c in _RUST_NUMERIC


PreTokenizer = Callable[[list[Piece]], list[Piece]]
# GPT-2's pre-tokenizer pattern: ``ByteLevel`` with ``use_regex``
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|"
                r"\s+")


def _char_splitter(pred: Callable[[str], bool], behavior: str) -> PreTokenizer:
    def run(pieces: list[Piece]) -> list[Piece]:
        out = []
        for p in pieces:
            out.extend(_split(p, _char_matches(p[0], pred), behavior))
        return out

    return run


def _unicode_scripts(pieces: list[Piece]) -> list[Piece]:
    """``UnicodeScripts``: a cut wherever the script changes, a space (and
    any code point the library's table lacks) joining the script before
    it; text before the first character of a script is dropped, as the
    library drops it."""
    out = []
    for text, first in pieces:
        cuts, last = [], None
        for i, c in enumerate(text):
            script = unicode_tables.script_of(ord(c))
            if script != unicode_tables.ANY:
                if script != last:
                    cuts.append(i)
                last = script
        cuts.append(len(text))
        out.extend((text[a:b], first and a == 0) for a, b in zip(cuts, cuts[1:]))
    return out


def build_pre_tokenizer(spec: Optional[dict], path: str) -> PreTokenizer:
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_pre_tokenizer(s, path) for s in spec["pretokenizers"]]

        def run(pieces: list[Piece]) -> list[Piece]:
            for step in steps:
                pieces = step(pieces)
            return pieces

        return run
    if kind == "Split":
        pattern, behavior = spec["pattern"], spec["behavior"]
        regex = (re.compile(re.escape(pattern["String"])) if "String" in pattern
                 else onig_to_re(pattern["Regex"], path))
        invert = bool(spec.get("invert", False))

        def split(pieces: list[Piece]) -> list[Piece]:
            out = []
            for p in pieces:
                spans = [(a, b, hit != invert) for a, b, hit in _regex_matches(p[0], regex)]
                out.extend(_split(p, spans, behavior))
            return out

        return split
    if kind == "ByteLevel":
        table, prefix = byte_to_unicode(), bool(spec.get("add_prefix_space", False))
        regex = onig_to_re(GPT2_PATTERN, path) if spec.get("use_regex", True) else None

        def byte_level(pieces: list[Piece]) -> list[Piece]:
            out = []
            for text, first in pieces:
                if prefix and not text.startswith(" "):
                    text = " " + text
                parts = ([(text, first)] if regex is None
                         else _split((text, first), _regex_matches(text, regex), "Isolated"))
                out.extend(("".join(table[b] for b in t.encode("utf-8")), f) for t, f in parts)
            return out

        return byte_level
    if kind == "Whitespace":
        words = re.compile(f"[{_word_body()}]+|[^{_word_body()}{_WS_BODY}]+")

        def whitespace(pieces: list[Piece]) -> list[Piece]:
            return [(m.group(), first and m.start() == 0) for text, first in pieces
                    for m in words.finditer(text)]

        return whitespace
    if kind == "WhitespaceSplit":
        return _char_splitter(WHITE_SPACE.__contains__, "Removed")
    if kind == "CharDelimiterSplit":
        return _char_splitter(spec["delimiter"].__eq__, "Removed")
    if kind == "Punctuation":
        return _char_splitter(_is_bert_punct, spec.get("behavior", "Isolated"))
    if kind == "Digits":
        return _char_splitter(_is_numeric, "Isolated" if spec.get("individual_digits")
                              else "Contiguous")
    if kind == "UnicodeScripts":
        return _unicode_scripts
    if kind == "FixedLength":
        size = int(spec.get("length", 5))
        if size < 1:
            raise ValueError(f"{path}: FixedLength length {size} is not positive")
        return lambda pieces: [(text[i: i + size], first and i == 0) for text, first in pieces
                               for i in range(0, len(text), size)]
    if kind == "BertPreTokenizer":

        def bert(pieces: list[Piece]) -> list[Piece]:
            out = []
            for p in pieces:
                for q in _split(p, _char_matches(p[0], WHITE_SPACE.__contains__), "Removed"):
                    out.extend(_split(q, _char_matches(q[0], _is_bert_punct), "Isolated"))
            return out

        return bert
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:  # the older serialization
            scheme = "always" if spec.get("add_prefix_space", True) else "never"
        do_split = spec.get("split", True)

        def metaspace(pieces: list[Piece]) -> list[Piece]:
            out = []
            for text, first in pieces:
                text = text.replace(" ", rep)
                if not text.startswith(rep) and (
                        scheme == "always" or (scheme == "first" and first)):
                    text = rep + text
                if do_split:
                    out.extend(_split((text, first), _char_matches(text, rep.__eq__),
                                      "MergedWithNext"))
                elif text:
                    out.append((text, first))
            return out

        return metaspace
    raise _refuse("pre-tokenizer", spec, path)


# ------------------------------------------------------------------ models


class WordLevel:
    def __init__(self, spec: dict, path: str) -> None:
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.path = path

    def tokenize(self, word: str) -> list[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk in self.vocab:
            return [self.vocab[self.unk]]
        raise ValueError(f"{self.path}: WordLevel has no unk token for {word!r}")


class WordPiece:
    def __init__(self, spec: dict, path: str) -> None:
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token", "[UNK]")
        self.prefix = spec.get("continuing_subword_prefix", "##")
        self.max_chars = spec.get("max_input_chars_per_word", 100)
        self.path = path

    def _unk(self) -> list[int]:
        if self.unk not in self.vocab:
            raise ValueError(f"{self.path}: WordPiece unk token {self.unk!r} is missing")
        return [self.vocab[self.unk]]

    def tokenize(self, word: str) -> list[int]:
        if len(word) > self.max_chars:
            return self._unk()
        out, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                sub = word[start:end] if start == 0 else self.prefix + word[start:end]
                if sub in self.vocab:
                    out.append(self.vocab[sub])
                    break
                end -= 1
            else:
                return self._unk()
            start = end
        return out


class BPE:
    """``tokenizers``' BPE. With ``dropout`` each merge popped is skipped
    with that probability, drawn from ``rng`` (the caller's, or one of the
    model's own): the skipped merges go back on the queue when the next
    merge is taken, and are lost when the queue runs dry."""

    def __init__(self, spec: dict, path: str, rng: Optional[random.Random] = None) -> None:
        dropout = spec.get("dropout")
        if dropout is not None and not 0.0 <= float(dropout) <= 1.0:
            raise ValueError(f"{path}: BPE dropout {dropout} is not in [0, 1]")
        self.dropout = float(dropout or 0.0)
        self.rng = rng if rng is not None else random.Random(0)
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.vocab: dict[str, int] = spec["vocab"]
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        self.path = path
        # (left id, right id) -> (rank, merged id)
        self.merges: dict[tuple[int, int], tuple[int, int]] = {}
        cut = len(self.prefix.encode("utf-8"))
        for rank, merge in enumerate(spec.get("merges", [])):
            a, b = merge if isinstance(merge, list) else merge.split(" ")
            if a not in self.vocab or b not in self.vocab:
                raise ValueError(f"{path}: BPE merge {merge!r} names a token outside the "
                                 "vocabulary")
            # the right side loses the prefix's length in bytes, whatever it starts with
            try:
                merged = a + b.encode("utf-8")[cut:].decode("utf-8")
            except UnicodeDecodeError as exc:
                raise ValueError(f"{path}: BPE merge {merge!r} cuts a character") from exc
            if merged not in self.vocab:
                raise ValueError(f"{path}: BPE merge {merge!r} makes {merged!r}, which is "
                                 "not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[merged])
        self._cache: dict[str, list[int]] = {}

    def tokenize(self, word: str) -> list[int]:
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        if self.dropout:
            return self._merge(self._symbols(word))
        cached = self._cache.get(word)
        if cached is None:
            cached = self._merge(self._symbols(word))
            if len(self._cache) < 100_000:
                self._cache[word] = cached
        return list(cached)

    def _symbols(self, word: str) -> list[int]:
        syms: list[int] = []
        unk: Optional[int] = None  # a pending unk's id
        last = len(word) - 1
        for i, c in enumerate(word):
            if i and self.prefix:
                c = self.prefix + c
            if i == last and self.suffix:
                c = c + self.suffix
            if c in self.vocab:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(self.vocab[c])
                continue
            if self.byte_fallback:
                codes = [f"<0x{b:02X}>" for b in c.encode("utf-8")]
                if all(code in self.vocab for code in codes):
                    syms.extend(self.vocab[code] for code in codes)
                    continue
            if self.unk is not None:
                if self.unk not in self.vocab:
                    raise ValueError(f"{self.path}: BPE unk token {self.unk!r} is not in "
                                     "the vocabulary")
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            syms.append(unk)
        return syms

    def _merge(self, syms: list[int]) -> list[int]:
        """Merge the lowest-ranked pair first, the leftmost of equal ranks,
        as ``tokenizers``' ``Word::merge_all`` does."""
        n = len(syms)
        if n < 2:
            return syms
        nxt = list(range(1, n + 1))
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = self.merges.get((syms[i], syms[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        skipped: list = []
        while heap:
            top = heapq.heappop(heap)
            if self.dropout and self.rng.random() < self.dropout:
                skipped.append(top)
                continue
            for entry in skipped:
                heapq.heappush(heap, entry)
            skipped.clear()
            rank, i, new = top
            j = nxt[i]
            if not alive[i] or j >= n:
                continue
            m = self.merges.get((syms[i], syms[j]))
            if m is None or m[1] != new:
                continue  # a stale entry
            syms[i] = new
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prv[nxt[i]] = i
            if prv[i] >= 0:
                m = self.merges.get((syms[prv[i]], new))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[i], m[1]))
            if nxt[i] < n:
                m = self.merges.get((new, syms[nxt[i]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], i, m[1]))
        return [s for s, a in zip(syms, alive) if a]


class Unigram:
    """SentencePiece's unigram model: the best-scoring segmentation by a
    Viterbi search over the pieces (``tokenizers``' ``encode_optimized``:
    ties keep the first candidate found), an unknown character scoring the
    lowest piece minus 10, consecutive unknowns fused into one."""

    UNK_PENALTY = 10.0

    def __init__(self, spec: dict, path: str) -> None:
        vocab = spec["vocab"]
        # a piece listed twice keeps its last id, and both ids decode to it
        self.tokens = [piece for piece, _score in vocab]
        self.pieces = {piece: i for i, piece in enumerate(self.tokens)}
        self.scores = [float(score) for _piece, score in vocab]
        self.unk_id = spec.get("unk_id")
        self.byte_fallback = bool(spec.get("byte_fallback", False))
        self.min_score = min(self.scores) if self.scores else 0.0
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self.path = path

    def tokenize(self, word: str) -> list[int]:
        n = len(word)
        if not n:
            return []
        unk_score = self.min_score - self.UNK_PENALTY
        best = [0.0] * (n + 1)
        start_of: list[Optional[int]] = [None] * (n + 1)
        ident = [0] * (n + 1)
        for s in range(n):
            base = best[s]
            single = False
            for e in range(s + 1, min(s + self.max_len, n) + 1):
                pid = self.pieces.get(word[s:e])
                if pid is None:
                    continue
                score = base + self.scores[pid]
                if start_of[e] is None or score > best[e]:
                    best[e], start_of[e], ident[e] = score, s, pid
                if e == s + 1:
                    single = True
            if not single:
                if self.unk_id is None:
                    raise ValueError(f"{self.path}: Unigram model has no unk_id")
                score = base + unk_score
                if start_of[s + 1] is None or score > best[s + 1]:
                    best[s + 1], start_of[s + 1], ident[s + 1] = score, s, self.unk_id
        pieces: list[str] = []
        unk_run: list[str] = []
        end = n
        while end > 0:
            s = start_of[end]
            if self.unk_id is not None and ident[end] == self.unk_id:
                unk_run.append(word[s:end])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(word[s:end])
            end = s
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        pieces.reverse()
        # a fused run of unknown characters is no piece: its bytes' pieces
        # with byte fallback when all are there, else the unk id
        ids: list[int] = []
        for piece in pieces:
            pid = self.pieces.get(piece)
            if pid is None and self.byte_fallback:
                codes = [self.pieces.get(f"<0x{b:02X}>") for b in piece.encode("utf-8")]
                if None not in codes:
                    ids.extend(codes)
                    continue
            ids.append(self.unk_id if pid is None else pid)
        return ids


_MODELS = {"WordLevel": WordLevel, "WordPiece": WordPiece, "BPE": BPE, "Unigram": Unigram}


def model_vocab(model) -> dict[str, int]:
    return model.pieces if isinstance(model, Unigram) else model.vocab


# ---------------------------------------------------------------- decoders

Decoder = Callable[[list[str]], list[str]]


def _byte_fallback(tokens: list[str]) -> list[str]:
    out: list[str] = []
    pending = bytearray()

    def flush() -> None:
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for tok in tokens:
        if len(tok) == 6 and tok.startswith("<0x") and tok.endswith(">"):
            try:
                pending.append(int(tok[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(tok)
    flush()
    return out


def _strip(content: str, start: int, stop: int) -> Decoder:
    def run(tokens: list[str]) -> list[str]:
        out = []
        for tok in tokens:
            a = 0
            while a < start and a < len(tok) and tok[a] == content:
                a += 1
            b, k = len(tok), 0
            while k < stop and b > a and tok[b - 1] == content:
                b -= 1
                k += 1
            out.append(tok[a:b])
        return out

    return run


def cleanup_spaces(text: str) -> str:
    """``transformers``' ``clean_up_tokenization`` and the WordPiece
    decoder's ``cleanup``."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _wordpiece_decoder(prefix: str, cleanup: bool) -> Decoder:
    def run(tokens: list[str]) -> list[str]:
        out = []
        for i, tok in enumerate(tokens):
            if i:
                tok = tok.replace(prefix, "", 1) if tok.startswith(prefix) else " " + tok
            if cleanup:
                tok = cleanup_spaces(tok).replace(" do not", " don't")
            out.append(tok)
        return out

    return run


def _ctc_decoder(pad: str, delimiter: str, cleanup: bool) -> Decoder:
    """CTC: repeats collapsed, the pad dropped, the word delimiter made a
    space after the WordPiece cleanup."""
    def run(tokens: list[str]) -> list[str]:
        out = []
        for tok, _ in itertools.groupby(tokens):
            tok = tok.replace(pad, "")
            if cleanup:
                tok = cleanup_spaces(tok).replace(" do not", " don't").replace(delimiter, " ")
            if tok:
                out.append(tok)
        return out

    return run


def build_decoder(spec: Optional[dict], path: str) -> Decoder:
    if spec is None:
        return lambda tokens: [" ".join(tokens)]
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [build_decoder(s, path) for s in spec["decoders"]]

        def run(tokens: list[str]) -> list[str]:
            for step in steps:
                tokens = step(tokens)
            return tokens

        return run
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "ByteLevel":
        back = {c: b for b, c in byte_to_unicode().items()}

        def byte_level(tokens: list[str]) -> list[str]:
            data = bytearray()
            for tok in tokens:
                if all(c in back for c in tok):
                    data.extend(back[c] for c in tok)
                else:
                    data.extend(tok.encode("utf-8"))
            return [data.decode("utf-8", errors="replace")]

        return byte_level
    if kind == "Replace":
        replace = _replacer(spec, path)
        return lambda tokens: [replace(t) for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Strip":
        return _strip(spec["content"], int(spec.get("start", 0)), int(spec.get("stop", 0)))
    if kind == "WordPiece":
        return _wordpiece_decoder(spec.get("prefix", "##"), bool(spec.get("cleanup", True)))
    if kind == "BPEDecoder":
        suffix = spec.get("suffix", "</w>")
        return lambda tokens: [t.replace(suffix, "" if i == len(tokens) - 1 else " ")
                               for i, t in enumerate(tokens)]
    if kind == "CTC":
        return _ctc_decoder(spec.get("pad_token", "<pad>"),
                            spec.get("word_delimiter_token", "|"),
                            bool(spec.get("cleanup", True)))
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme")
        if scheme is None:
            scheme = "always" if spec.get("add_prefix_space", True) else "never"

        def metaspace(tokens: list[str]) -> list[str]:
            out = []
            for i, tok in enumerate(tokens):
                drop = i == 0 and scheme != "never"
                out.append("".join("" if c == rep and drop else (" " if c == rep else c)
                                   for c in tok))
            return out

        return metaspace
    raise _refuse("decoder", spec, path)


# ------------------------------------------------------------ added tokens


class AddedToken:
    __slots__ = ("content", "id", "special", "normalized", "lstrip", "rstrip", "single_word")

    def __init__(self, content: str, id: int, special: bool = False,
                 normalized: bool = True, lstrip: bool = False, rstrip: bool = False,
                 single_word: bool = False) -> None:
        self.content, self.id, self.special = content, id, special
        self.normalized, self.lstrip, self.rstrip = normalized, lstrip, rstrip
        self.single_word = single_word


def _is_word_char(c: str) -> bool:
    return c.isalnum()


class AddedTokenSplitter:
    """One pass of ``AddedVocabulary::find_matches``: leftmost-longest
    matches of the tokens' texts, each kept only if its flags allow it."""

    def __init__(self, tokens: dict[str, AddedToken]) -> None:
        self.tokens = tokens
        alts = sorted(tokens, key=len, reverse=True)
        self.regex = re.compile("|".join(map(re.escape, alts))) if alts else None

    def split(self, text: str) -> list[tuple[int, int, Optional[AddedToken]]]:
        if self.regex is None or not text:
            return [(0, len(text), None)]
        out, offset = [], 0
        for m in self.regex.finditer(text):
            tok = self.tokens[m.group()]
            start, stop = m.start(), m.end()
            if tok.single_word:
                if (start > 0 and _is_word_char(text[start - 1])) or (
                        stop < len(text) and _is_word_char(text[stop])):
                    continue
            if tok.lstrip:
                k = start
                while k > 0 and text[k - 1] in WHITE_SPACE:
                    k -= 1
                start = max(k, offset)
            if tok.rstrip:
                while stop < len(text) and text[stop] in WHITE_SPACE:
                    stop += 1
            if offset < start:
                out.append((offset, start, None))
            out.append((start, stop, tok))
            offset = stop
        if offset != len(text):
            out.append((offset, len(text), None))
        return out


# --------------------------------------------------------------- tokenizer


class TokenizerJson:
    """The ``tokenizer.json`` pipeline: ``encode`` (no special tokens
    added) and ``decode``."""

    def __init__(self, spec: dict, path: str = "tokenizer.json",
                 rng: Optional[random.Random] = None) -> None:
        model = spec.get("model") or {}
        cls = _MODELS.get(model.get("type"))
        if cls is None:
            raise _refuse("model", model, path)
        self.model = cls(model, path, rng) if cls is BPE else cls(model, path)
        self.vocab = model_vocab(self.model)
        self.id_to_token = (dict(enumerate(self.model.tokens)) if isinstance(self.model, Unigram)
                            else {i: t for t, i in self.vocab.items()})
        self.normalize = build_normalizer(spec.get("normalizer"), path)
        self.pre_tokenize = build_pre_tokenizer(spec.get("pre_tokenizer"), path)
        self.decoder = build_decoder(spec.get("decoder"), path)
        self.added: dict[str, AddedToken] = {}
        self.added_by_id: dict[int, AddedToken] = {}
        for tok in spec.get("added_tokens") or []:
            self._register(AddedToken(tok["content"], int(tok["id"]),
                                      special=bool(tok.get("special", False)),
                                      normalized=bool(tok.get("normalized", True)),
                                      lstrip=bool(tok.get("lstrip", False)),
                                      rstrip=bool(tok.get("rstrip", False)),
                                      single_word=bool(tok.get("single_word", False))))
        self._rebuild()

    @property
    def vocab_size(self) -> int:
        return len(self.id_to_token)

    def _register(self, tok: AddedToken) -> None:
        self.added[tok.content] = tok
        self.added_by_id[tok.id] = tok

    def _rebuild(self) -> None:
        raw = {c: t for c, t in self.added.items() if not t.normalized}
        # a normalized token is matched in its normalized form
        norm = {self.normalize(c): t for c, t in self.added.items() if t.normalized}
        self._raw = AddedTokenSplitter(raw)
        self._norm = AddedTokenSplitter({c: t for c, t in norm.items() if c})
        self.special = {t.content for t in self.added.values() if t.special}

    def add_special(self, content: str) -> None:
        """``add_tokens`` of a special token the tokenizer does not hold
        yet (a special token named only in the config): the model's id, or
        the next free one."""
        if content in self.added:
            return
        tid = self.vocab.get(content)
        if tid is None:
            ids = [t.id for t in self.added.values()]
            size = self.vocab_size
            top = max(ids) if ids else None
            tid = size if top is None or (top < size and size) else top + 1
        self._register(AddedToken(content, tid, special=True, normalized=False))
        self._rebuild()

    def token_to_id(self, token: str) -> Optional[int]:
        if token in self.added:
            return self.added[token].id
        return self.vocab.get(token)

    def encode(self, text: str) -> list[int]:
        ids: list[int] = []
        for a, b, tok in self._raw.split(text):
            if tok is not None:
                ids.append(tok.id)
                continue
            if a == b:
                continue
            normed = self.normalize(text[a:b])
            for c, d, ntok in self._norm.split(normed):
                if ntok is not None:
                    ids.append(ntok.id)
                    continue
                if c == d:
                    continue
                for word, _first in self.pre_tokenize([(normed[c:d], a == 0 and c == 0)]):
                    ids.extend(self.model.tokenize(word))
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = True) -> str:
        tokens = []
        for i in ids:
            tok = self.added_by_id.get(i)
            content = tok.content if tok is not None else self.id_to_token.get(i)
            if content is None or (skip_special_tokens and content in self.special):
                continue
            tokens.append(content)
        return "".join(self.decoder(tokens))


# -------------------------------------------------------- the directory

SPECIAL_NAMES = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token",
                 "cls_token", "mask_token")


def _token_text(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


def read_directory(path: str, rng: Optional[random.Random] = None
                   ) -> tuple[TokenizerJson, dict[str, Optional[str]], bool]:
    """(pipeline, special token texts by name, clean_up_tokenization_spaces)
    of a tokenizer directory, as ``AutoTokenizer.from_pretrained`` reads
    them: ``tokenizer_config.json``, with ``special_tokens_map.json`` over
    it when the config has no ``added_tokens_decoder``; every special token
    named there that the tokenizer does not hold is added. ``rng`` draws a
    BPE model's dropout."""
    root = Path(path)
    tj = root / "tokenizer.json"
    if not tj.is_file():
        raise ValueError(f"{path}: no tokenizer.json (the port reads fast-tokenizer "
                         "directories only)")
    pipeline = TokenizerJson(json.loads(tj.read_text(encoding="utf-8")), str(tj), rng)
    config_path = root / "tokenizer_config.json"
    config = json.loads(config_path.read_text(encoding="utf-8")) \
        if config_path.is_file() else {}
    map_path = root / "special_tokens_map.json"
    if "added_tokens_decoder" not in config and map_path.is_file():
        for key, value in json.loads(map_path.read_text(encoding="utf-8")).items():
            if key == "additional_special_tokens":
                extra = list(config.get(key) or [])
                extra += [v for v in value if v not in extra]
                value = extra
            config[key] = value
    for idx, tok in sorted((config.get("added_tokens_decoder") or {}).items(),
                           key=lambda kv: int(kv[0])):
        if tok["content"] not in pipeline.added:
            pipeline._register(AddedToken(tok["content"], int(idx),
                                          special=bool(tok.get("special", False)),
                                          normalized=bool(tok.get("normalized", True)),
                                          lstrip=bool(tok.get("lstrip", False)),
                                          rstrip=bool(tok.get("rstrip", False)),
                                          single_word=bool(tok.get("single_word", False))))
            pipeline._rebuild()
    names = {name: _token_text(config.get(name)) for name in SPECIAL_NAMES}
    extra = [_token_text(v) for v in config.get("additional_special_tokens") or []]
    for text in [*names.values(), *extra]:
        if text:
            pipeline.add_special(text)
    return pipeline, names, bool(config.get("clean_up_tokenization_spaces", False))


def special_id(pipeline: TokenizerJson, text: Optional[str]) -> int:
    """A named special token's id, 0 when none is named (JAX's rule)."""
    if not text:
        return 0
    tid = pipeline.token_to_id(text)
    return tid if tid is not None else 0
