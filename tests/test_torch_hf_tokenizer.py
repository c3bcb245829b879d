"""The port's Hugging Face tokenizer (``sentio_tpu_torch/models/
hf_tokenizer.py`` behind ``models/tokenizer.py::HFTokenizer``) against the
JAX package's ``HFTokenizer`` (``transformers``) on the same directories.

The layouts are built in-process with ``tokenizers`` and saved with
``PreTrainedTokenizerFast.save_pretrained``, each with the components of
the family it stands for: the char-level ``WordLevel`` of the JAX
package's end-to-end test, Llama-3's byte-level BPE, Llama-2 / Mixtral's
byte-fallback BPE, BERT's WordPiece, XLM-R's Unigram with ``NFKC`` and
with its real ``Sequence[Precompiled, Replace]`` normalizer, RoBERTa's
byte-level BPE on GPT-2's regex, T5's ``Precompiled`` / ``WhitespaceSplit``
/ byte-fallback Unigram, ALBERT's normalizer chain and CLIP's BPE with an
end-of-word suffix; small layouts carry every other component (``Nmt``,
``NFD``, ``Strip``, ``Whitespace``, ``CharDelimiterSplit``,
``Punctuation``, ``Digits``, ``UnicodeScripts``, ``FixedLength``, ``CTC``,
BPE ``dropout`` at 0 and 1 and ``continuing_subword_prefix``). Ids,
decodes, ``vocab_size`` and the five special ids must be equal, exactly,
on hard strings, a ``hypothesis`` property over text and random id lists;
BPE dropout between 0 and 1 is held in law. The Unicode drift tables are
held to the library, range by range, and a component of an unknown
``type`` raises a named error. The module's ``build_layout``,
``build_charsmap`` and charsmap rules are shared with the convert,
``Precompiled`` and end-to-end tests.
"""

from __future__ import annotations

import base64
import json
import random
import shutil
import string
import unicodedata

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")
tokenizers = pytest.importorskip("tokenizers")

from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402
from tokenizers import (  # noqa: E402
    AddedToken,
    Regex,
    Tokenizer,
    decoders,
    models,
    normalizers,
    pre_tokenizers,
    trainers,
)

from sentio_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer  # noqa: E402
from sentio_tpu_torch.models import hf_tokenizer, unicode_drift  # noqa: E402
from sentio_tpu_torch.models.tokenizer import HFTokenizer, get_tokenizer  # noqa: E402

LLAMA3_PATTERN = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                  r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
CORPUS = [
    "The quick brown fox jumps over the lazy dog.",
    "Hello, world! It's 2024; we've got 123456 items and they'll ship.",
    "Ünïcödé façade naïve café — “quotes” and ‘apostrophes’.",
    "日本語のテキストと中文文本。 한국어 문장도 있습니다.",
    "emoji 😀🎉👍🏽 and symbols ±×÷²³ ½ Ⅻ ٣٤٥",
    "tabs\tand\nnewlines\r\nmixed   spaces",
    "don't can't won't I'm you're they'll she'd",
    "A systolic array multiplies matrices; retrieval-augmented generation cites sources.",
    "Παράδειγμα ελληνικού κειμένου. Пример русского текста.",
    "code: def f(x): return x ** 2 # comment",
] * 6
HARD = [
    "", " ", "   ", "\t\n", "\r\n", "a\r\nb\n\n", "  leading", "trailing  ",
    "don't I'M they'LL we'Ve", "12345678", "3.14159 10,000.50", "Ünïcödé café naïve",
    "²³ ٣٤٥ Ⅻ ½ ①", "日本語のテキスト", "😀🎉 👍🏽 🧑‍🚀", "hello<s>world", "<s> </s> <pad>",
    "[CLS] x [SEP] [MASK]", "<|begin_of_text|>hi<|end_of_text|>", "x\x1cy\x85z\x00w",
    "ΑΣ ΟΔΟΣ", "İstanbul ǅ ß", "ﬁ ﬀ ㍿ ℌ", "a" * 150, " <mask> x", "a<mask>b",
    "Hello World hello world", "xyz axyz xyz.", "[[X]]   tail", "​ 　",
    "Ｆｕｌｌｗｉｄｔｈ", "é é", "à̖b",
]
LAYOUTS = ("wordlevel", "llama3", "llama2", "bert", "xlmr", "xlmr_real", "roberta", "t5",
           "albert", "clip", "nmt", "punct", "scripts", "ctc", "dropout0", "dropout1")
CLIP_PATTERN = (r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|"
                r"[\p{N}]|[^\s\p{L}\p{N}]+")
# multi-code-point keys of a cluster under 6 bytes (looked up whole), and
# keys of 6 bytes or more (never matched whole: their clusters go code
# point by code point)
CLUSTER_KEYS = {"e\u0301": "\u00e9", "n\u0303": "\u00f1", "\u0438\u0306": "\u0439",
                "\u00e9\u0301": "E", "a\u0300\u0301": "A2", "\r\n": "\n", "q\u200d": "Q"}
LONG_KEYS = {"\u0915\u094d\u0937": "KSSA", "\U0001f1e6\U0001f1e7": "AB",
             "e\u0301\u0301\u0301": "E3", "\u1100\u1161\u11a8": "GAG"}


def build_charsmap(rules: dict) -> bytes:
    """SentencePiece's precompiled character map of ``rules`` (key →
    replacement): a little-endian u32 of the trie's bytes, a darts-clone
    double array packed first fit (a node's children take the first free
    base of the last 16 blocks of 256 units; bases never repeat; the array
    ends on a block), the
    NUL-terminated replacements."""
    import struct

    strings, value_of = bytearray(), {}
    for rep in sorted(set(rules.values())):
        value_of[rep] = len(strings)
        strings += rep.encode() + b"\0"
    root: dict = {}
    for key, rep in rules.items():
        node = root
        for b in key.encode():
            node = node.setdefault(b, {})
        node[-1] = value_of[rep]
    units = [0] * 256
    # skip[i] == i marks a free unit; a taken one points to a later free one
    skip, bases = list(range(257)), set()
    skip[0] = 1

    def free_from(i: int) -> int:
        top = i
        while skip[top] != top:
            top = skip[top]
        while skip[i] != top:
            skip[i], i = top, skip[i]
        return top

    stack = [(root, 0)]
    while stack:
        node, pos = stack.pop()
        labels = sorted(k for k in node if k >= 0)
        slots = ([0] if -1 in node else []) + labels
        if not slots:
            continue
        # first fit within the last 16 blocks: older holes stay empty
        p = free_from(max(1, len(units) - 4096))
        while True:
            base = p ^ slots[0]
            while (base | 0xFF) >= len(units):
                skip[len(units):] = range(len(units), len(units) + 257)
                units += [0] * 256
            if base not in bases and all(skip[base ^ c] == base ^ c for c in slots[1:]):
                break
            p = free_from(p + 1)
        bases.add(base)
        offset = pos ^ base
        assert offset < 1 << 21
        units[pos] |= offset << 10 | (1 << 8 if -1 in node else 0)
        for c in slots:
            skip[base ^ c] = (base ^ c) + 1
        if -1 in node:
            units[base] = node[-1] | 1 << 31
        for c in labels:
            units[base ^ c] = c
            stack.append((node[c], base ^ c))
    return struct.pack(f"<I{len(units)}I", 4 * len(units), *units) + bytes(strings)


def nfkc_rules() -> dict:
    """NFKC of every code point that it changes, with the cluster and long
    keys."""
    import unicodedata

    rules = {}
    for cp in range(1, 0x110000):
        c = chr(cp)
        if not 0xD800 <= cp <= 0xDFFF and unicodedata.normalize("NFKC", c) != c:
            rules[c] = unicodedata.normalize("NFKC", c)
    return {**rules, **CLUSTER_KEYS, **LONG_KEYS}


def nmt_rules() -> dict:
    """``Nmt``'s rules as a character map: controls dropped, spaces made
    ' '."""
    drop = [*range(0x1, 0x9), 0xB, *range(0xE, 0x20), 0x7F, 0x8F, 0x9F]
    space = [0x9, 0xA, 0xC, 0xD, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029, 0x2581,
             0xFEFF, 0xFFFD]
    return {**{chr(c): "" for c in drop}, **{chr(c): " " for c in space}}


_BLOBS: dict = {}


def nfkc_charsmap() -> bytes:
    if "nfkc" not in _BLOBS:
        _BLOBS["nfkc"] = build_charsmap(nfkc_rules())
    return _BLOBS["nfkc"]


def _save(tok: Tokenizer, path, **special) -> str:
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tok, **special)
    fast.save_pretrained(str(path))
    return str(path)


def _wordlevel(path) -> str:
    chars = sorted(set(string.ascii_letters + string.digits + string.punctuation + " "))
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3}
    for c in chars:
        vocab[c] = len(vocab)
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Split(Regex("."), behavior="isolated")
    tok.decoder = decoders.Fuse()
    return _save(tok, path, pad_token="<pad>", bos_token="<s>", eos_token="</s>",
                 unk_token="<unk>")


def _llama3(path) -> str:
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False)])
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=700, initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    extra = ["<|reserved_special_token_0|>", "<|start_header_id|>", "<|end_header_id|>",
             "<|eot_id|>"]
    return _save(tok, path, bos_token="<|begin_of_text|>", eos_token="<|end_of_text|>",
                 additional_special_tokens=extra)


def _llama2(path) -> str:
    base = Tokenizer(models.BPE())
    base.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                            normalizers.Replace(" ", "▁")])
    base.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=500, show_progress=False))
    trained = json.loads(base.to_str())["model"]
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    for t in sorted(trained["vocab"], key=trained["vocab"].get):
        vocab.setdefault(t, len(vocab))
    merges = [tuple(m) for m in trained["merges"]]
    tok = Tokenizer(models.BPE(vocab, merges, unk_token="<unk>", byte_fallback=True,
                               fuse_unk=True))
    tok.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    tok.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    return _save(tok, path, bos_token="<s>", eos_token="</s>", unk_token="<unk>")


def _bert(path) -> str:
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]", max_input_chars_per_word=100))
    tok.normalizer = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=True,
                                                strip_accents=None, lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    tok.decoder = decoders.WordPiece(prefix="##")
    tok.train_from_iterator(CORPUS, trainers.WordPieceTrainer(
        vocab_size=400, special_tokens=["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"],
        show_progress=False))
    # a normalized phrase and a single-word token beside the specials
    tok.add_tokens([AddedToken("hello world", normalized=True),
                    AddedToken("xyz", single_word=True, normalized=False)])
    return _save(tok, path, pad_token="[PAD]", unk_token="[UNK]", cls_token="[CLS]",
                 sep_token="[SEP]", mask_token="[MASK]")


def _xlmr(path) -> str:
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizers.NFKC()
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always",
                                                 split=True)
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.train_from_iterator(CORPUS * 4, trainers.UnigramTrainer(
        vocab_size=400, special_tokens=["<s>", "<pad>", "</s>", "<unk>"], unk_token="<unk>",
        show_progress=False))
    # XLM-R's mask strips the space before it; a right-stripping marker
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, normalized=False)])
    tok.add_tokens([AddedToken("[[X]]", rstrip=True, normalized=False)])
    return _save(tok, path, bos_token="<s>", eos_token="</s>", pad_token="<pad>",
                 unk_token="<unk>", cls_token="<s>", sep_token="</s>", mask_token="<mask>")


def _unigram(normalizer, pre_tokenizer, specials, vocab_size=400):
    tok = Tokenizer(models.Unigram())
    tok.normalizer = normalizer
    tok.pre_tokenizer = pre_tokenizer
    tok.train_from_iterator(CORPUS * 4, trainers.UnigramTrainer(
        vocab_size=vocab_size, special_tokens=specials, unk_token="<unk>",
        show_progress=False))
    return tok


def _metaspace():
    return pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always", split=True)


def _xlmr_real(path) -> str:
    """XLM-R's and bge-m3's real layout: ``Precompiled`` then ``Replace``
    of two or more spaces."""
    tok = _unigram(normalizers.Sequence([normalizers.Precompiled(nfkc_charsmap()),
                                         normalizers.Replace(Regex(" {2,}"), " ")]),
                   _metaspace(), ["<s>", "<pad>", "</s>", "<unk>"])
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, normalized=False)])
    return _save(tok, path, bos_token="<s>", eos_token="</s>", pad_token="<pad>",
                 unk_token="<unk>", cls_token="<s>", sep_token="</s>", mask_token="<mask>")


def _roberta(path) -> str:
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<s>", "<pad>", "</s>", "<unk>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
    tok.add_special_tokens([AddedToken("<mask>", lstrip=True, normalized=False)])
    return _save(tok, path, bos_token="<s>", eos_token="</s>", pad_token="<pad>",
                 unk_token="<unk>", cls_token="<s>", sep_token="</s>", mask_token="<mask>")


def _t5(path) -> str:
    norm = normalizers.Precompiled(nfkc_charsmap())
    pre = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(), _metaspace()])
    base = _unigram(norm, pre, ["<pad>", "</s>", "<unk>"], vocab_size=300)
    vocab = json.loads(base.to_str())["model"]["vocab"]
    vocab += [[f"<0x{b:02X}>", -30.0] for b in range(256)]
    tok = Tokenizer(models.Unigram([tuple(v) for v in vocab], unk_id=2, byte_fallback=True))
    tok.normalizer, tok.pre_tokenizer = norm, pre
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    return _save(tok, path, eos_token="</s>", pad_token="<pad>", unk_token="<unk>")


def _albert(path) -> str:
    norm = normalizers.Sequence([
        normalizers.Replace("``", '"'), normalizers.Replace("''", '"'), normalizers.NFKD(),
        normalizers.StripAccents(), normalizers.Lowercase(),
        normalizers.Precompiled(nfkc_charsmap()), normalizers.Replace(Regex(" {2,}"), " ")])
    tok = _unigram(norm, _metaspace(), ["<pad>", "<unk>", "[CLS]", "[SEP]", "[MASK]"])
    tok.decoder = decoders.Metaspace(replacement="▁", prepend_scheme="always", split=True)
    return _save(tok, path, pad_token="<pad>", unk_token="<unk>", cls_token="[CLS]",
                 sep_token="[SEP]", mask_token="[MASK]")


def _clip(path) -> str:
    tok = Tokenizer(models.BPE(unk_token="<|endoftext|>", end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([normalizers.NFC(),
                                           normalizers.Replace(Regex(r"\s+"), " "),
                                           normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(CLIP_PATTERN), behavior="removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    tok.decoder = decoders.BPEDecoder(suffix="</w>")
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=600, special_tokens=["<|startoftext|>", "<|endoftext|>"],
        end_of_word_suffix="</w>", initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False))
    return _save(tok, path, bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                 unk_token="<|endoftext|>", pad_token="<|endoftext|>")


def _nmt(path) -> str:
    tok = Tokenizer(models.WordPiece(unk_token="[UNK]"))
    tok.normalizer = normalizers.Sequence([normalizers.Nmt(), normalizers.NFD(),
                                           normalizers.Strip(left=True, right=True)])
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.decoder = decoders.WordPiece(prefix="##")
    tok.train_from_iterator(CORPUS, trainers.WordPieceTrainer(
        vocab_size=400, special_tokens=["[PAD]", "[UNK]"], show_progress=False))
    return _save(tok, path, pad_token="[PAD]", unk_token="[UNK]")


def _punct(path) -> str:
    tok = Tokenizer(models.BPE(unk_token="[UNK]", continuing_subword_prefix="##"))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.WhitespaceSplit(), pre_tokenizers.Punctuation(behavior="contiguous"),
        pre_tokenizers.Digits(individual_digits=True)])
    tok.decoder = decoders.WordPiece(prefix="##")
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=500, special_tokens=["[PAD]", "[UNK]"], continuing_subword_prefix="##",
        show_progress=False))
    return _save(tok, path, pad_token="[PAD]", unk_token="[UNK]")


def _scripts(path) -> str:
    pre = pre_tokenizers.Sequence([
        pre_tokenizers.CharDelimiterSplit("|"), pre_tokenizers.UnicodeScripts(),
        pre_tokenizers.Punctuation(behavior="merged_with_previous"),
        pre_tokenizers.Digits(individual_digits=False)])
    tok = _unigram(normalizers.Lowercase(), pre, ["<pad>", "<unk>"], vocab_size=300)
    tok.decoder = decoders.Fuse()
    return _save(tok, path, pad_token="<pad>", unk_token="<unk>")


def _ctc(path) -> str:
    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.normalizer = normalizers.Sequence([normalizers.Lowercase(),
                                           normalizers.Replace(" ", "|")])
    tok.pre_tokenizer = pre_tokenizers.FixedLength(length=3)
    tok.decoder = decoders.CTC(pad_token="<pad>", word_delimiter_token="|", cleanup=True)
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=300, special_tokens=["<pad>", "<unk>"], show_progress=False))
    return _save(tok, path, pad_token="<pad>", unk_token="<unk>")


def _dropout(path, p: float) -> str:
    tok = Tokenizer(models.BPE())
    tok.normalizer = normalizers.ByteLevel()
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(
        vocab_size=500, special_tokens=["<|end|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False))
    data = json.loads(tok.to_str())
    data["model"]["dropout"] = p
    return _save(Tokenizer.from_str(json.dumps(data)), path, eos_token="<|end|>")


_BUILDERS = {"wordlevel": _wordlevel, "llama3": _llama3, "llama2": _llama2, "bert": _bert,
             "xlmr": _xlmr, "xlmr_real": _xlmr_real, "roberta": _roberta, "t5": _t5,
             "albert": _albert, "clip": _clip, "nmt": _nmt, "punct": _punct,
             "scripts": _scripts, "ctc": _ctc, "dropout0": lambda p: _dropout(p, 0.0),
             "dropout1": lambda p: _dropout(p, 1.0)}


def build_layout(name: str, path) -> str:
    """Write the ``name`` layout's tokenizer directory at ``path``."""
    return _BUILDERS[name](path)


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    return {name: build_layout(name, tmp_path_factory.mktemp(f"tok_{name}"))
            for name in LAYOUTS}


@pytest.fixture(scope="module")
def pairs(layouts):
    return {name: (JaxHFTokenizer(path), HFTokenizer(path)) for name, path in layouts.items()}


def _same_encode(jax_tok, tok, text):
    for add_bos in (False, True):
        for add_eos in (False, True):
            want = jax_tok.encode(text, add_bos=add_bos, add_eos=add_eos)
            assert tok.encode(text, add_bos=add_bos, add_eos=add_eos) == want, (
                text, add_bos, add_eos)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_vocab_size_and_special_ids(pairs, layout):
    jax_tok, tok = pairs[layout]
    assert tok.vocab_size == jax_tok.vocab_size
    for name in ("pad_id", "bos_id", "eos_id", "cls_id", "sep_id"):
        assert getattr(tok, name) == getattr(jax_tok, name), name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_hard_strings_encode_and_decode(pairs, layout):
    jax_tok, tok = pairs[layout]
    for text in HARD + CORPUS[:10]:
        _same_encode(jax_tok, tok, text)
        ids = jax_tok.encode(text)
        assert tok.decode(ids) == jax_tok.decode(ids), text


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_random_ids(pairs, layout):
    """Special ids are skipped, ids past the vocabulary dropped, byte pieces
    that do not form UTF-8 replaced, as ``transformers`` decodes."""
    jax_tok, tok = pairs[layout]
    top = len(jax_tok._tok) + 8
    rng = random.Random(layout)
    for _ in range(200):
        ids = [rng.randrange(top) for _ in range(rng.randint(0, 14))]
        assert tok.decode(ids) == jax_tok.decode(ids), ids


@pytest.mark.parametrize("layout", LAYOUTS)
@settings(max_examples=120, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=st.text(max_size=40))
def test_property_encode_equals_jax(pairs, layout, text):
    jax_tok, tok = pairs[layout]
    want = jax_tok.encode(text)
    assert tok.encode(text) == want
    assert tok.decode(want) == jax_tok.decode(want)


def test_get_tokenizer_kinds(layouts):
    assert isinstance(get_tokenizer("hf", path=layouts["bert"]), HFTokenizer)
    from sentio_tpu.models.tokenizer import get_tokenizer as jax_get

    for kind in ("byte", "hash"):
        ours, theirs = get_tokenizer(kind, 300), jax_get(kind, 300)
        assert ours.encode("Hello wide World", add_bos=True) == theirs.encode(
            "Hello wide World", add_bos=True)
    with pytest.raises(ValueError, match="unknown tokenizer kind"):
        get_tokenizer("sentencepiece")


def _bert_norm(**kw):
    base = dict(clean_text=False, handle_chinese_chars=False, strip_accents=False,
                lowercase=False)
    base.update(kw)
    return normalizers.BertNormalizer(**base), hf_tokenizer._bert_normalizer(base)


def _range_cps(ranges):
    return [c for r in ranges for c in range(r[0], r[1] + 1)]


@pytest.mark.parametrize("table", ["strip", "lower", "nfkc", "punct", "onig", "format", "nfd",
                                   "marks", "numeric"])
def test_unicode_drift_tables_hold_to_the_library(table):
    """Every code point of each drift range gets the library's treatment
    from the port, and so do a seeded sample of the rest."""
    rng = random.Random(table)
    sample = [c for c in (rng.randrange(0x110000) for _ in range(3000))
              if not 0xD800 <= c <= 0xDFFF]
    if table == "strip":
        lib, ours = _bert_norm(strip_accents=True)
        cps = _range_cps(unicode_drift.STRIP_KEEP + unicode_drift.STRIP_DROP)
        check = lambda c: lib.normalize_str(c) == ours(c)  # noqa: E731
    elif table == "lower":
        lib, ours = _bert_norm(lowercase=True)
        cps = _range_cps(unicode_drift.LOWER_DELTA)
        check = lambda c: lib.normalize_str(c) == ours(c)  # noqa: E731
    elif table == "format":
        lib, ours = _bert_norm(clean_text=True)
        cps = _range_cps(unicode_drift.NEWER_FORMAT)
        check = lambda c: lib.normalize_str(c) == ours(c)  # noqa: E731
    elif table == "nfkc":
        lib = normalizers.NFKC()
        ours = hf_tokenizer.build_normalizer({"type": "NFKC"}, "t")
        cps = _range_cps(unicode_drift.NFKC_KEEP)
        check = lambda c: lib.normalize_str(c) == ours(c)  # noqa: E731
    elif table == "nfd":
        forms = [(getattr(normalizers, f)(), hf_tokenizer.build_normalizer({"type": f}, "t"))
                 for f in ("NFD", "NFKD", "NFC", "NFKC")]
        cps = _range_cps(unicode_drift.NFD_KEEP)

        def check(c):
            # the character, and its decomposition, which the library does
            # not compose
            texts = (c, unicodedata.normalize("NFD", c))
            return all(lib.normalize_str(t) == ours(t) for lib, ours in forms for t in texts)
    elif table == "marks":
        lib = normalizers.StripAccents()
        ours = hf_tokenizer.build_normalizer({"type": "StripAccents"}, "t")
        cps = _range_cps(unicode_drift.MARK_KEEP + unicode_drift.MARK_DROP)
        check = lambda c: lib.normalize_str("a" + c) == ours("a" + c)  # noqa: E731
    elif table == "numeric":
        lib = pre_tokenizers.Digits(individual_digits=True)
        ours = hf_tokenizer.build_pre_tokenizer({"type": "Digits", "individual_digits": True},
                                                "t")
        cps = _range_cps(unicode_drift.RUST_NUMERIC)
        check = lambda c: ([p for p, _ in lib.pre_tokenize_str("a" + c + "b")]  # noqa: E731
                           == [p for p, _ in ours([("a" + c + "b", True)])])
    elif table == "punct":
        lib = pre_tokenizers.BertPreTokenizer()
        ours = hf_tokenizer.build_pre_tokenizer({"type": "BertPreTokenizer"}, "t")
        cps = _range_cps(unicode_drift.PUNCT_ADD + unicode_drift.PUNCT_DROP)
        check = lambda c: ([p for p, _ in lib.pre_tokenize_str("a" + c + "b")]  # noqa: E731
                           == [p for p, _ in ours([("a" + c + "b", True)])])
    elif table == "onig":
        spec = {"type": "Split", "pattern": {"Regex": LLAMA3_PATTERN}, "behavior": "Isolated",
                "invert": False}
        lib = pre_tokenizers.Split(Regex(LLAMA3_PATTERN), behavior="isolated")
        ours = hf_tokenizer.build_pre_tokenizer(spec, "t")
        cps = _range_cps(unicode_drift.ONIG_L + unicode_drift.ONIG_N)

        def check(c):
            text = "a" + c + "1 " + c + "a"
            return [p for p, _ in lib.pre_tokenize_str(text)] == [p for p, _ in
                                                                 ours([(text, True)])]
    bad = [hex(c) for c in cps + sample if not check(chr(c))]
    assert not bad, bad[:20]


def _with_component(src, dst, where, spec):
    shutil.copytree(src, dst)
    data = json.loads((dst / "tokenizer.json").read_text())
    data[where] = spec
    (dst / "tokenizer.json").write_text(json.dumps(data))
    return str(dst)


def _precompiled_spec():
    return {"type": "Precompiled",
            "precompiled_charsmap": base64.b64encode(nfkc_charsmap()).decode()}


@pytest.mark.parametrize("where,spec", [
    ("normalizer", "precompiled"),
    ("normalizer", {"type": "Sequence", "normalizers": [
        "precompiled", {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]}),
    ("normalizer", {"type": "NFD"}),
    ("pre_tokenizer", {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
                       "use_regex": True}),
    ("pre_tokenizer", {"type": "Digits", "individual_digits": True}),
    ("decoder", {"type": "CTC", "pad_token": "<pad>", "word_delimiter_token": "|",
                 "cleanup": True}),
])
def test_formerly_refused_component_matches_jax(layouts, tmp_path, where, spec):
    """The components the port once refused, each put into XLM-R's layout
    in turn: ids and decodes equal JAX's."""
    if spec == "precompiled":
        spec = _precompiled_spec()
    elif spec.get("type") == "Sequence":
        spec = {**spec, "normalizers": [_precompiled_spec(), *spec["normalizers"][1:]]}
    d = _with_component(layouts["xlmr"], tmp_path / "tok", where, spec)
    jax_tok, tok = JaxHFTokenizer(d), HFTokenizer(d)
    for text in HARD + CORPUS[:10]:
        _same_encode(jax_tok, tok, text)
        ids = jax_tok.encode(text)
        assert tok.decode(ids) == jax_tok.decode(ids), text


@pytest.mark.parametrize("where,spec", [
    ("normalizer", {"type": "NFKX"}),
    ("normalizer", {"type": "Sequence", "normalizers": [{"type": "Lowercase"},
                                                        {"type": "Casefold"}]}),
    ("normalizer", {"type": "Sequence", "normalizers": [
        {"type": "Sequence", "normalizers": [{"type": "Transliterate"}]}]}),
    ("pre_tokenizer", {"type": "SentencePieceSplit"}),
    ("pre_tokenizer", {"type": "Sequence", "pretokenizers": [{"type": "Whitespace"},
                                                             {"type": "Syllables"}]}),
    ("decoder", {"type": "Detokenize"}),
    ("model", {"type": "WordPieceV2", "vocab": {}}),
    ("decoder", {"type": "Sequence", "decoders": [{"type": "Fuse"}, {"type": "Titlecase"}]}),
])
def test_unsupported_component_is_named(layouts, tmp_path, where, spec):
    """A component of a ``type`` that ``tokenizers`` does not define raises
    a ValueError naming it and the file, inside a Sequence too; nothing
    falls back to the byte tokenizer."""
    d = _with_component(layouts["xlmr"], tmp_path / "tok", where, spec)
    inner = spec
    while inner.get("type") == "Sequence":
        inner = (inner.get("normalizers") or inner.get("pretokenizers")
                 or inner.get("decoders"))[-1]
    with pytest.raises(ValueError, match=rf"tokenizer\.json.*'{inner['type']}'"):
        HFTokenizer(d)


def test_bpe_dropout_is_held_in_law(layouts, tmp_path):
    """BPE dropout 0.3: the port (drawing from a seeded ``random.Random``)
    and ``tokenizers`` (its thread RNG) give each token of a word at the
    same rate per encode, within 0.06 over 10,000 encodes each (about six
    standard errors of the difference)."""
    d = tmp_path / "tok"
    shutil.copytree(layouts["dropout0"], d)
    data = json.loads((d / "tokenizer.json").read_text())
    data["model"]["dropout"] = 0.3
    (d / "tokenizer.json").write_text(json.dumps(data))
    jax_tok, tok = JaxHFTokenizer(str(d)), HFTokenizer(str(d), rng=random.Random(7))
    text, n = "the quick brown fox", 10_000
    rates = []
    for t in (jax_tok, tok):
        counts: dict = {}
        for _ in range(n):
            for i in t.encode(text):
                counts[i] = counts.get(i, 0) + 1
        rates.append({i: c / n for i, c in counts.items()})
    assert len({tuple(tok.encode(text)) for _ in range(50)}) > 1  # the draws vary
    for i in set(rates[0]) | set(rates[1]):
        assert abs(rates[0].get(i, 0.0) - rates[1].get(i, 0.0)) < 0.06, (
            tok.decode([i]), rates[0].get(i), rates[1].get(i))


def test_unsupported_model_is_named(layouts, tmp_path):
    import shutil

    d = tmp_path / "tok"
    shutil.copytree(layouts["bert"], d)
    data = json.loads((d / "tokenizer.json").read_text())
    data["model"]["type"] = "WordPieceV2"
    (d / "tokenizer.json").write_text(json.dumps(data))
    with pytest.raises(ValueError, match="model 'WordPieceV2'"):
        HFTokenizer(str(d))


def test_missing_tokenizer_json_is_named(tmp_path):
    with pytest.raises(ValueError, match="no tokenizer.json"):
        HFTokenizer(str(tmp_path))


def test_batch_encode_with_hf_tokenizer_matches_jax(pairs):
    """The batch helpers pad with the directory's pad id, as JAX's do."""
    from sentio_tpu.models.tokenizer import batch_encode as jax_batch
    from sentio_tpu.models.tokenizer import batch_encode_pairs as jax_pairs
    from sentio_tpu_torch.models.tokenizer import batch_encode, batch_encode_pairs

    jax_tok, tok = pairs["bert"]
    texts = ["Hello, world!", "", "The quick brown fox jumps."]
    for a, b in zip(batch_encode(tok, texts, 16), jax_batch(jax_tok, texts, 16)):
        np.testing.assert_array_equal(a, b)
    qd = [("what is it?", "A systolic array."), ("x", "")]
    for a, b in zip(batch_encode_pairs(tok, qd, 24), jax_pairs(jax_tok, qd, 24)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("family", ["llama", "cross-encoder"])
def test_vocab_larger_than_the_model_raises_jax_error(layouts, tmp_path, family):
    """A tokenizer whose vocabulary outgrows the checkpoint's model is
    refused with the JAX ``WeightsError`` message, by the generator's and
    the cross-encoder's loaders alike."""
    import dataclasses

    import torch

    from sentio_tpu.runtime.weights import WeightsError as JWeightsError
    from sentio_tpu.runtime.weights import load_model as jload_model
    from sentio_tpu_torch.config import GeneratorConfig, RerankConfig
    from sentio_tpu_torch.models.cross_encoder import init_cross_encoder
    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.models.transformer import EncoderConfig
    from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
    from sentio_tpu_torch.runtime import weights
    from sentio_tpu_torch.runtime.engine import GeneratorEngine

    tok_dir = layouts["wordlevel"]  # 99 ids
    gen = torch.Generator().manual_seed(0)
    path = tmp_path / "ck"
    if family == "llama":
        cfg = dataclasses.replace(LlamaConfig.tiny(), vocab_size=64, dtype="float32")
        weights.save_pytree(path, weights.decoder_to_jax(init_llama(cfg, gen, "cpu")),
                            meta={"family": "llama", "config": cfg.__dict__})
    else:
        cfg = dataclasses.replace(EncoderConfig.tiny(), vocab_size=64, dtype="float32")
        tree = init_cross_encoder(cfg, gen, "cpu")
        weights.save_pytree(path, {"encoder": weights.encoder_to_jax(tree["encoder"]),
                                   "head": weights._to_jax(tree["head"])},
                            meta={"family": "cross-encoder", "config": cfg.__dict__})
    with pytest.raises(JWeightsError) as theirs:
        jload_model(str(path), expect_family=family, tokenizer_path=tok_dir)
    with pytest.raises(weights.WeightsError) as ours:
        if family == "llama":
            GeneratorEngine(config=GeneratorConfig(checkpoint_path=str(path),
                                                   tokenizer_path=tok_dir), device="cpu")
        else:
            CrossEncoderReranker(RerankConfig(checkpoint_path=str(path),
                                              tokenizer_path=tok_dir), device="cpu")
    assert str(ours.value) == str(theirs.value)
    assert "has vocab 99 > model vocab 64" in str(ours.value)


@pytest.mark.parametrize("case", ["config_special", "decoder_entry", "legacy_map"])
def test_tokens_named_only_in_the_config(layouts, tmp_path, case):
    """Special tokens the config names but ``tokenizer.json`` lacks are
    added as ``transformers`` adds them (the next free id), an
    ``added_tokens_decoder`` entry too, and without that key
    ``special_tokens_map.json`` overrides the config's names: ids,
    special ids and decodes equal JAX's."""
    import shutil

    d = tmp_path / "tok"
    shutil.copytree(layouts["wordlevel"], d)
    config = json.loads((d / "tokenizer_config.json").read_text())
    if case == "config_special":
        config.update(sep_token="<sep>", cls_token="<s>")
    elif case == "decoder_entry":
        config["added_tokens_decoder"]["99"] = {
            "content": "<extra>", "lstrip": False, "normalized": False, "rstrip": False,
            "single_word": False, "special": True}
    else:
        config.pop("added_tokens_decoder")
        config["bos_token"] = "</s>"
        (d / "special_tokens_map.json").write_text(json.dumps(
            {"bos_token": "<s>", "eos_token": {"content": "<eos2>", "lstrip": False,
                                               "normalized": False, "rstrip": False,
                                               "single_word": False}}))
    (d / "tokenizer_config.json").write_text(json.dumps(config))
    jax_tok, tok = JaxHFTokenizer(str(d)), HFTokenizer(str(d))
    for name in ("pad_id", "bos_id", "eos_id", "cls_id", "sep_id"):
        assert getattr(tok, name) == getattr(jax_tok, name), name
    assert tok.vocab_size == jax_tok.vocab_size
    text = "a<sep>b<extra>c<eos2>d<s>"
    _same_encode(jax_tok, tok, text)
    ids = list(range(len(jax_tok._tok) + 2))
    assert tok.decode(ids) == jax_tok.decode(ids)
