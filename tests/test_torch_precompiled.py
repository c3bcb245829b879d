"""The port's ``Precompiled`` normalizer (``sentio_tpu_torch/models/
charsmap.py``), its grapheme segmenter (``models/graphemes.py``) and the
``Script`` and ``\\w`` tables (``models/unicode_tables.py``) against
``tokenizers`` and ``regex``.

Character maps are built here (``build_charsmap`` of the tokenizer tests):
``NFKC`` of every code point with multi-code-point cluster keys and keys of
6 bytes or more, and ``Nmt``'s rules. The port's normalizer must equal
``tokenizers.normalizers.Precompiled(blob).normalize_str`` on every code
point and on a ``hypothesis`` property rich in combining marks, ZWJ,
regional indicators, Hangul jamo, Indic viramas and ``InCB`` consonants.

Each table equals ``regex``'s property range by range. The library's own
clusters are seen through character maps whose keys are candidate
clusters (a key matches only a whole cluster under 6 bytes): every code
point after a letter, before a letter and before a combining mark is one
cluster with it, or not, as the library says; so every drift range is held
to the library, and so is everything else the library lets one see. The
scripts are held to ``UnicodeScripts`` (each script's code points one
piece, each pair of scripts two, the code points of no script joining
either side) and ``\\w`` to ``Whitespace`` on every assigned code point.
"""

from __future__ import annotations

import collections
import itertools

import pytest

tokenizers = pytest.importorskip("tokenizers")
regex = pytest.importorskip("regex")

from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from test_torch_hf_tokenizer import build_charsmap, nfkc_rules, nmt_rules  # noqa: E402
from tokenizers import normalizers, pre_tokenizers  # noqa: E402

from sentio_tpu_torch.models import charsmap, graphemes, hf_tokenizer  # noqa: E402
from sentio_tpu_torch.models import unicode_tables as tables  # noqa: E402

CODE_POINTS = [c for c in range(0x110000) if not 0xD800 <= c <= 0xDFFF]
ALL_TEXT = "".join(map(chr, CODE_POINTS))
ASSIGNED = {ord(c) for c in regex.findall(r"[^\p{Cn}\p{Co}]", ALL_TEXT)}
# the alphabet of the property: combining marks, ZWJ / ZWNJ, regional
# indicators, emoji and modifiers, Hangul jamo and syllables, Devanagari and
# Bengali consonants with viramas and nuktas, prepends, spacing marks,
# controls, CR LF, spaces, the map's keys and the drift code points
ALPHABET = ("a", "e", "n", "q", "и", "é", "́", "̀", "̃", "̆",
            "‍", "‌", "\U0001f1e6", "\U0001f1e7", "\U0001f1e8", "\U0001f468",
            "\U0001f469", "\U0001f3fb", "❤", "️", "©", "ᄀ", "ᅡ",
            "ᆨ", "가", "각", "क", "ष", "्", "ि", "़",
            "ক", "্", "়", "ำ", "؀", "ः", "\r", "\n", "\t",
            " ", " ", "　", "\x00", "\x01", "\x7f", "ﬁ", "①", "Ａ",
            "᫏", "\U00011a3a", "\U000e0020", "ͅ", "ᾀ", "▁", "﻿")


@pytest.fixture(scope="module")
def maps():
    return {"nfkc": build_charsmap(nfkc_rules()), "nmt": build_charsmap(nmt_rules())}


@pytest.mark.parametrize("name", ["nfkc", "nmt"])
def test_every_code_point_equals_the_library(maps, name):
    lib, ours = normalizers.Precompiled(maps[name]), charsmap.CharsMap(maps[name])
    bad = [hex(c) for c in CODE_POINTS if ours.normalize(chr(c)) != lib.normalize_str(chr(c))]
    assert not bad, bad[:20]


@pytest.mark.parametrize("name", ["nfkc", "nmt"])
@settings(max_examples=400, deadline=None)
@given(text=st.text(alphabet=st.sampled_from(ALPHABET), max_size=24))
def test_property_equals_the_library(maps, name, text):
    blob = maps[name]
    assert charsmap.CharsMap(blob).normalize(text) == normalizers.Precompiled(
        blob).normalize_str(text)


def test_precompiled_in_a_tokenizer_json_equals_the_library(maps):
    """The normalizer as ``tokenizer.json`` names it: base64, in a
    ``Sequence`` with ``Replace``."""
    import base64

    spec = {"type": "Sequence", "normalizers": [
        {"type": "Precompiled",
         "precompiled_charsmap": base64.b64encode(maps["nfkc"]).decode()},
        {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}
    ours = hf_tokenizer.build_normalizer(spec, "t")
    lib = normalizers.Sequence([normalizers.Precompiled(maps["nfkc"]),
                                normalizers.Replace(tokenizers.Regex(" {2,}"), " ")])
    for text in ("a  b　　c", "ﬁ ①  x", "é  ñ",
                 "\r\n\r\n", "क्ष \U0001f1e6\U0001f1e7"):
        assert ours(text) == lib.normalize_str(text), text


@pytest.mark.parametrize("blob,match", [
    (b"\x01\x00", "has no trie size"),
    (b"\x00\x01\x00\x00" + b"\x00" * 8, "does not fit"),
    (b"\x04\x00\x00\x00\x00\x00\x00\x00\xff\xfe", "not UTF-8"),
])
def test_malformed_charsmap_is_refused(blob, match):
    with pytest.raises(ValueError, match=match):
        charsmap.CharsMap(blob, "t.json")


def test_charsmap_that_is_not_base64_is_refused():
    with pytest.raises(ValueError, match="t.json: precompiled_charsmap is not base64"):
        hf_tokenizer.build_normalizer({"type": "Precompiled", "precompiled_charsmap": "@@"},
                                      "t.json")


# ------------------------------------------------------------------ tables


def _runs(cps) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for c in cps:
        if out and out[-1][1] == c - 1:
            out[-1][1] = c
        else:
            out.append([c, c])
    return [tuple(r) for r in out]


def _regex_runs(cls: str) -> list[tuple[int, int]]:
    return _runs(ord(c) for c in regex.findall(f"[{cls}]", ALL_TEXT))


GCB_NAMES = {"CR": "CR", "LF": "LF", "Control": "CN", "Extend": "EX", "ZWJ": "ZWJ",
             "Regional_Indicator": "RI", "Prepend": "PP", "SpacingMark": "SM", "L": "L",
             "V": "V", "T": "T"}


@pytest.mark.parametrize("prop", ["break", "hangul", "extended_pictographic", "incb"])
def test_grapheme_tables_equal_regex(prop):
    if prop == "break":
        for name, short in GCB_NAMES.items():
            cls = getattr(graphemes, short)
            ours = [(a, b) for a, b, k in graphemes.GRAPHEME_BREAK if k == cls]
            assert ours == _regex_runs(rf"\p{{Grapheme_Cluster_Break={name}}}"), name
    elif prop == "hangul":
        for name, cls in (("LV", graphemes.LV), ("LVT", graphemes.LVT)):
            want = _regex_runs(rf"\p{{Grapheme_Cluster_Break={name}}}")
            ours = _runs(c for c in range(0xAC00, 0xD7A4) if graphemes.break_class(c) == cls)
            assert ours == want, name
    elif prop == "extended_pictographic":
        assert list(graphemes.EXTENDED_PICTOGRAPHIC) == _regex_runs(
            r"\p{Extended_Pictographic}")
    else:
        for name in ("Consonant", "Extend", "Linker"):
            assert list(getattr(graphemes, f"INCB_{name.upper()}")) == _regex_runs(
                rf"\p{{InCB={name}}}"), name


# every code point after a letter, before a letter, before a combining mark
PROBES = {"after_letter": lambda c: "a" + c, "before_letter": lambda c: c + "a",
          "before_mark": lambda c: c + "́"}


@pytest.mark.parametrize("probe", list(PROBES))
def test_grapheme_clusters_hold_to_the_library(probe):
    """A map whose keys are the candidate pairs (each mapped to U+0001)
    shows the library's clusters: a pair under 6 bytes is replaced only
    when it is one cluster. The port's segmenter (its drift ranges
    applied) must agree on every assigned code point (``regex``'s
    Unicode, private use left out) but LF and CR, which separate the pairs,
    and on every drift code point."""
    make = PROBES[probe]
    drift = {c for a, b, _ in graphemes.GRAPHEME_DRIFT for c in range(a, b + 1)}
    cps = [c for c in sorted(drift | ASSIGNED) if c not in (0xA, 0xD)
           and len(make(chr(c)).encode()) < 6]
    bad = []
    for i in range(0, len(cps), 100_000):
        part = cps[i: i + 100_000]
        pairs = [make(chr(c)) for c in part]
        lib = normalizers.Precompiled(build_charsmap(dict.fromkeys(pairs, "\x01")))
        got = lib.normalize_str("\n".join(pairs)).split("\n")
        bad += [hex(c) for c, pair, out in zip(part, pairs, got)
                if (out == "\x01") != (len(graphemes.clusters(pair)) == 1)]
    assert not bad, bad[:20]


@settings(max_examples=400, deadline=None)
@given(text=st.text(alphabet=st.sampled_from(ALPHABET), max_size=24))
def test_clusters_equal_regex_outside_the_drift(text):
    """``regex``'s ``\\X`` (its newer Unicode) splits as the port does
    where no drift code point stands."""
    drift = {chr(c) for a, b, _ in graphemes.GRAPHEME_DRIFT for c in range(a, b + 1)}
    text = "".join(c for c in text if c not in drift)
    assert graphemes.clusters(text) == regex.findall(r"\X", text)


def test_script_table_equals_regex():
    for i, name in enumerate(tables.SCRIPT_NAMES, start=1):
        ours = [(a, b) for a, b, s in tables.SCRIPTS if s == i]
        assert ours == _regex_runs(rf"\p{{Script={name}}}"), name
    assert not any(s == 0 for _a, _b, s in tables.SCRIPTS)


def _pieces(pre, text: str) -> list[str]:
    return [p for p, _ in pre.pre_tokenize_str(text)]


def test_script_drift_holds_to_the_library():
    """Under the port's table (its drift and remapping applied) each
    script's code points form one ``UnicodeScripts`` piece, a code point of
    one script then one of another two pieces, and the code points of no
    script join the script on either side."""
    lib = pre_tokenizers.UnicodeScripts()
    groups = collections.defaultdict(list)
    for c in CODE_POINTS:
        groups[tables.script_of(c)].append(chr(c))
    joiners = "".join(groups.pop(tables.ANY))
    assert _pieces(lib, "α" + joiners + "a") == ["α" + joiners, "a"]
    assert _pieces(lib, "a" + joiners + "α") == ["a" + joiners, "α"]
    split = [tables.SCRIPT_NAMES[s - 1] for s, chars in groups.items()
             if len(_pieces(lib, "".join(chars))) != 1]
    assert not split, split
    reps = {s: chars[len(chars) // 2] for s, chars in groups.items()}
    joined = [(a, b) for a, b in itertools.permutations(reps, 2)
              if len(_pieces(lib, reps[a] + reps[b])) != 2]
    assert not joined, joined[:10]
    drift = {c for a, b, _ in tables.SCRIPT_DRIFT for c in range(a, b + 1)}
    assert drift and drift <= set(CODE_POINTS)


@settings(max_examples=400, deadline=None)
@given(text=st.text(alphabet=st.sampled_from(
    ("a", "b", " ", "α", "あ", "ア", "ー", "一", "́", "1",
     ".", "͸", "Ᲊ", "॓", "։", "؜", "ا", "\U00016100", "|",
     "\U0001f600")), max_size=20))
def test_unicode_scripts_equals_the_library(text):
    ours = hf_tokenizer.build_pre_tokenizer({"type": "UnicodeScripts"}, "t")
    assert [p for p, _ in ours([(text, True)])] == _pieces(pre_tokenizers.UnicodeScripts(),
                                                           text)


def test_word_table_equals_regex():
    assert list(tables.WORD) == _regex_runs(r"\w")
    drift = {c for a, b in tables.WORD_DRIFT for c in range(a, b + 1)}
    assert drift <= {c for a, b in tables.WORD for c in range(a, b + 1)}


def test_whitespace_holds_to_the_library():
    """``Whitespace`` (``\\w+|[^\\w\\s]+``) on "a" + c + "a" for every
    assigned code point c (``regex``'s Unicode, private use left out; no
    other is ``\\w`` in either) and every drift one, in batches: the port's
    pieces are the library's."""
    lib = pre_tokenizers.Whitespace()
    ours = hf_tokenizer.build_pre_tokenizer({"type": "Whitespace"}, "t")
    cps = sorted(ASSIGNED | {c for a, b in tables.WORD_DRIFT for c in range(a, b + 1)})
    bad = []
    for i in range(0, len(cps), 50_000):
        part = cps[i: i + 50_000]
        text = " ".join("a" + chr(c) + "a" for c in part)
        want = _pieces(lib, text)
        if [p for p, _ in ours([(text, True)])] != want:
            bad += [hex(c) for c in part
                    if [p for p, _ in ours([("a" + chr(c) + "a", True)])]
                    != _pieces(lib, "a" + chr(c) + "a")]
    assert not bad, bad[:20]


def test_nmt_every_code_point_equals_the_library():
    lib = normalizers.Nmt()
    ours = hf_tokenizer.build_normalizer({"type": "Nmt"}, "t")
    bad = [hex(c) for c in CODE_POINTS if ours(chr(c)) != lib.normalize_str(chr(c))]
    assert not bad, bad[:20]
