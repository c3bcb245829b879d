"""The port's checkpoint converter (``sentio_tpu_torch/models/convert.py``
and ``python -m sentio_tpu_torch convert``) against the JAX package's
(``sentio_tpu/models/convert.py``, ``cli convert``).

Tiny Hugging Face models are built in-process with ``transformers`` —
Llama (untied and tied), Mixtral, BERT, XLM-R and cross-encoders with
both head styles — and saved as safetensors (also sharded, and in bf16
and f16), and once as ``pytorch_model.bin``. Each package's ``load_*_dir``
must give the same tree leaf for leaf (dtype, shape and bytes) at float32
and bfloat16; a ``config.json`` with its optional keys deleted must give
the same config; the port's defaults are held to the installed
``transformers``; the port's CLI output loads in JAX's ``load_model`` to
the same tree, and JAX's ``_cmd_convert`` output loads in the port's."""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from sentio_tpu.models import convert as jconvert  # noqa: E402
from sentio_tpu.runtime.weights import load_model as jload_model  # noqa: E402
from sentio_tpu_torch.models import convert  # noqa: E402
from sentio_tpu_torch.runtime import weights  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _llama(tied: bool):
    cfg = transformers.LlamaConfig(vocab_size=300, hidden_size=32, intermediate_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   num_key_value_heads=2, max_position_embeddings=64,
                                   rope_theta=10_000.0, tie_word_embeddings=tied)
    torch.manual_seed(0)
    return transformers.LlamaForCausalLM(cfg).eval()


def _mixtral():
    cfg = transformers.MixtralConfig(vocab_size=300, hidden_size=32, intermediate_size=64,
                                     num_hidden_layers=2, num_attention_heads=4,
                                     num_key_value_heads=2, num_local_experts=4,
                                     num_experts_per_tok=2, max_position_embeddings=64)
    torch.manual_seed(1)
    return transformers.MixtralForCausalLM(cfg).eval()


def _bert_cfg(**kw):
    return dict(vocab_size=120, hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
                intermediate_size=64, max_position_embeddings=64, **kw)


def _bert():
    torch.manual_seed(2)
    return transformers.BertModel(transformers.BertConfig(**_bert_cfg())).eval()


def _xlmr():
    torch.manual_seed(3)
    return transformers.XLMRobertaModel(transformers.XLMRobertaConfig(
        **_bert_cfg(type_vocab_size=1))).eval()


def _ce_roberta():
    torch.manual_seed(4)
    return transformers.XLMRobertaForSequenceClassification(transformers.XLMRobertaConfig(
        **_bert_cfg(type_vocab_size=1, num_labels=1))).eval()


def _ce_bert():
    torch.manual_seed(5)
    return transformers.BertForSequenceClassification(transformers.BertConfig(
        **_bert_cfg(num_labels=1))).eval()


# (family, what makes the model, save_pretrained kwargs, the cast before saving)
CASES = {
    "llama": ("llama", lambda: _llama(False), {}, None),
    "llama_tied": ("llama", lambda: _llama(True), {}, None),
    "llama_sharded_bf16": ("llama", lambda: _llama(False), {"max_shard_size": "40KB"},
                           torch.bfloat16),
    "llama_bin": ("llama", lambda: _llama(False), {"safe_serialization": False}, None),
    "moe": ("moe", _mixtral, {}, None),
    "moe_f16": ("moe", _mixtral, {}, torch.float16),
    "bert": ("encoder", _bert, {}, None),
    "xlmr_bf16": ("encoder", _xlmr, {}, torch.bfloat16),
    "ce_roberta": ("cross-encoder", _ce_roberta, {}, None),
    "ce_bert": ("cross-encoder", _ce_bert, {"safe_serialization": False}, None),
}


def save_hf(name: str, path) -> str:
    """Write the ``name`` case's Hugging Face directory at ``path``."""
    _family, build, kwargs, cast = CASES[name]
    model = build()
    if cast is not None:
        model = model.to(cast)
    model.save_pretrained(str(path), **kwargs)
    return str(path)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    return {name: save_hf(name, tmp_path_factory.mktemp(name)) for name in CASES}


def _jax_load(family, src, dtype):
    if family == "llama":
        return jconvert.load_llama_dir(src, dtype)
    if family == "moe":
        return jconvert.load_moe_dir(src, dtype)
    return jconvert.load_encoder_dir(src, dtype, cross_encoder=family == "cross-encoder")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _dtype_name(arr) -> str:
    if isinstance(arr, torch.Tensor):
        return str(arr.dtype).replace("torch.", "")
    return "bfloat16" if arr.dtype == weights.BF16 else str(arr.dtype)


def _bytes(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        arr = arr.view(torch.int16).numpy() if arr.dtype == torch.bfloat16 else arr.numpy()
    arr = np.asarray(arr)
    if arr.dtype == weights.BF16 or str(arr.dtype) == "bfloat16":
        arr = arr.view(np.uint16)
    return np.ascontiguousarray(arr).tobytes()


def _assert_same_tree(ours, theirs):
    a, b = _flat(ours), _flat(theirs)
    assert sorted(a) == sorted(b)
    for key in a:
        assert _dtype_name(a[key]) == _dtype_name(b[key]), key
        assert tuple(a[key].shape) == tuple(b[key].shape), key
        assert _bytes(a[key]) == _bytes(b[key]), key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_trees_equal_jax_leaf_for_leaf(hf_dirs, case, dtype):
    family = CASES[case][0]
    ours, ocfg = convert.load_family_dir(family, hf_dirs[case], dtype)
    theirs, tcfg = _jax_load(family, hf_dirs[case], dtype)
    assert ocfg.__dict__ == tcfg.__dict__
    _assert_same_tree(ours, theirs)


OPTIONAL = ("rms_norm_eps", "max_position_embeddings", "rope_theta", "num_key_value_heads",
            "type_vocab_size", "pad_token_id", "num_local_experts", "num_experts_per_tok",
            "tie_word_embeddings")


@pytest.mark.parametrize("case", ["llama", "moe", "bert", "xlmr_bf16", "ce_roberta"])
def test_trimmed_config_json_gives_jax_config(hf_dirs, tmp_path, case):
    """The keys ``transformers`` defaults: deleted from config.json, the
    port's config still equals the JAX one (``AutoConfig``'s defaults)."""
    import shutil

    family = CASES[case][0]
    src = tmp_path / "hf"
    shutil.copytree(hf_dirs[case], src)
    data = json.loads((src / "config.json").read_text())
    for key in OPTIONAL:
        data.pop(key, None)
    (src / "config.json").write_text(json.dumps(data))
    hf = convert.HFConfig.from_dir(src)
    auto = transformers.AutoConfig.from_pretrained(str(src), local_files_only=True)
    if family in ("llama", "moe"):
        conv = convert.moe_config_from_hf if family == "moe" else convert.llama_config_from_hf
        jconv = jconvert.moe_config_from_hf if family == "moe" else \
            jconvert.llama_config_from_hf
    else:
        conv, jconv = convert.encoder_config_from_hf, jconvert.encoder_config_from_hf
        assert convert._position_offset(hf) == jconvert._position_offset(auto)
    assert conv(hf, "float32").__dict__ == jconv(auto, "float32").__dict__


@pytest.mark.parametrize("model_type", sorted(convert.HF_DEFAULTS))
def test_defaults_are_transformers_defaults(model_type):
    cls = transformers.AutoConfig.for_model(model_type).__class__
    ref = cls()
    for key, value in convert.HF_DEFAULTS[model_type].items():
        if value is None:  # the head count, as the class derives it
            assert getattr(ref, key) == ref.num_attention_heads, key
        else:
            assert getattr(ref, key) == value, key


def test_unknown_model_type_is_named(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "gpt2"}))
    with pytest.raises(convert.ConversionError, match="model_type 'gpt2'"):
        convert.load_llama_dir(tmp_path)


def test_position_offset_matches_jax_branches():
    for model_type in ("bert", "roberta", "xlm-roberta", "camembert"):
        for pad in (0, 1, 5, None):
            data = {"model_type": model_type, "pad_token_id": pad}
            auto = argparse.Namespace(**{**convert.HF_DEFAULTS[model_type], **data})
            assert convert._position_offset(convert.HFConfig(data)) == \
                jconvert._position_offset(auto), (model_type, pad)


@pytest.mark.parametrize("values", [
    np.array([1.0, -2.5, 3.14159, 1e-30, 65504.0, 3.4e38, -0.0, np.inf, -np.inf],
             np.float32),
    np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 100,
])
def test_bf16_rounding_matches_ml_dtypes(values):
    import ml_dtypes

    ours = convert.f32_to_bf16(values).view(np.uint16)
    theirs = values.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(convert.bf16_to_f32(convert.f32_to_bf16(values)),
                                  values.astype(ml_dtypes.bfloat16).astype(np.float32))
    with np.errstate(over="ignore"):
        f16 = values.astype(np.float16)
    np.testing.assert_array_equal(
        convert.cast_leaf(f16, "bfloat16").view(np.uint16),
        f16.astype(ml_dtypes.bfloat16).view(np.uint16))


def test_missing_weights_raise(tmp_path):
    (tmp_path / "config.json").write_text(json.dumps({"model_type": "llama"}))
    with pytest.raises(convert.ConversionError, match="no safetensors or torch .bin"):
        convert.load_llama_dir(tmp_path)


def test_cli_convert_loads_in_jax_and_jax_cli_loads_in_the_port(hf_dirs, tmp_path):
    """``python -m sentio_tpu_torch convert`` in a subprocess (JAX's
    arguments and JSON line) writes what JAX's ``load_model`` reads to the
    tree of JAX's own conversion; JAX's ``_cmd_convert`` output loads in
    the port's ``load_model`` to the port's own conversion."""
    from sentio_tpu.cli import _cmd_convert as jax_cmd_convert

    dst = tmp_path / "ours"
    out = subprocess.run(
        [sys.executable, "-m", "sentio_tpu_torch", "convert", "cross-encoder",
         hf_dirs["ce_roberta"], str(dst), "--dtype", "bfloat16"],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    _, tcfg = _jax_load("cross-encoder", hf_dirs["ce_roberta"], "bfloat16")
    assert line == {"family": "cross-encoder", "dst": str(dst), "config": tcfg.__dict__}
    params, cfg, tok = jload_model(str(dst), expect_family="cross-encoder")
    assert tok is None and cfg.__dict__ == tcfg.__dict__
    _assert_same_tree(_flat_np(params), _jax_load("cross-encoder", hf_dirs["ce_roberta"],
                                                  "bfloat16")[0])

    jdst = tmp_path / "theirs"
    assert jax_cmd_convert(argparse.Namespace(family="llama", src=hf_dirs["llama_tied"],
                                              dst=str(jdst), dtype="float32")) == 0
    loaded, lcfg = weights.load_model(jdst, expect_family="llama")
    ours, ocfg = convert.load_llama_dir(hf_dirs["llama_tied"], "float32")
    assert lcfg == type(lcfg)(**ocfg.__dict__)
    _assert_same_tree(weights.decoder_to_jax(loaded), ours)


def _flat_np(tree):
    return {k: _flat_np(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


def test_port_cli_writes_every_family(hf_dirs, tmp_path, capsys):
    """The in-process CLI for each family: the checkpoint loads in the
    port's ``load_model`` with the family's config."""
    from sentio_tpu_torch.__main__ import main

    for case in ("llama", "moe", "bert", "ce_bert"):
        family = CASES[case][0]
        dst = tmp_path / case
        assert main(["convert", family, hf_dirs[case], str(dst), "--dtype", "float32"]) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        params, cfg = weights.load_model(dst, expect_family=family)
        assert line["config"] == cfg.__dict__


# ------------------------------------------------------------- end to end

E2E_DOCS = [
    "TPUs multiply matrices using a systolic array called the MXU.",
    "Paged attention reads keys and values through a page table of fixed pages.",
    "The verifier audits an answer against its numbered sources.",
    "A radix tree shares prompt heads between requests.",
]
E2E_QUESTION = "What multiplies matrices on a TPU?"


def _smoke():
    if str(REPO) not in sys.path:
        sys.path.insert(0, str(REPO))
    import chip_smoke

    return chip_smoke


def _e2e_words() -> list:
    import re

    return sorted({w for t in E2E_DOCS + [E2E_QUESTION] for w in re.findall(r"\w+", t)})


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """A tiny Llama (vocab of the char-level WordLevel tokenizer; weights
    drawn wide, so greedy decoding has no near-tied logits for the summation
    order of a thread count to flip), a tiny XLM-R encoder with the
    embedder's tokenizer ``chip_smoke.py`` writes (XLM-R's layout:
    ``Precompiled`` and ``Replace``, ``Metaspace``, ``Unigram``) and a BERT
    cross-encoder (vocab of a WordPiece), each converted at float32 by the
    port's CLI, beside their tokenizers."""
    from test_torch_hf_tokenizer import build_layout

    from sentio_tpu_torch.__main__ import main

    root = tmp_path_factory.mktemp("e2e")
    toks = {name: build_layout(name, root / f"tok_{name}") for name in ("wordlevel", "bert")}
    toks["xlmr"] = str(root / "tok_xlmr")
    _smoke().write_unigram_tokenizer(toks["xlmr"], _e2e_words())
    torch.manual_seed(11)
    llama = transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=512,
        tie_word_embeddings=False, initializer_range=0.5)).eval()
    enc_cfg = dict(vocab_size=512, hidden_size=32, num_hidden_layers=2,
                   num_attention_heads=4, intermediate_size=64, max_position_embeddings=128)
    encoder = transformers.XLMRobertaModel(transformers.XLMRobertaConfig(
        **{**enc_cfg, "max_position_embeddings": 130}, type_vocab_size=1,
        pad_token_id=1)).eval()
    ce = transformers.BertForSequenceClassification(transformers.BertConfig(
        **enc_cfg, num_labels=1)).eval()
    out = {"tok": toks}
    for family, model in (("llama", llama), ("encoder", encoder), ("cross-encoder", ce)):
        src, dst = root / f"hf_{family}", root / f"ck_{family}"
        model.save_pretrained(str(src))
        assert main(["convert", family, str(src), str(dst), "--dtype", "float32"]) == 0
        out[family] = str(dst)
    return out


def _e2e_sections(converted):
    gen = dict(provider="tpu", checkpoint_path=converted["llama"],
               tokenizer_path=converted["tok"]["wordlevel"], use_verifier=False,
               max_new_tokens=24, max_prompt_tokens=400, mode="fast", dtype="float32",
               use_paged_decode=True, kv_page_size=16, kv_max_pages_per_seq=32,
               max_batch_size=4, context_token_budget=60)
    emb = dict(provider="tpu", dim=32, checkpoint_path=converted["encoder"],
               tokenizer_path=converted["tok"]["xlmr"], coalesce=False, cache_size=0)
    rr = dict(kind="cross_encoder", top_k=2, checkpoint_path=converted["cross-encoder"],
              tokenizer_path=converted["tok"]["bert"])
    return dict(retrieval=dict(strategy="dense", top_k=3), embedder=emb, rerank=rr,
                generator=gen)


def _port_answer(converted, **serve):
    from sentio_tpu_torch.config import (
        EmbedderConfig,
        GeneratorConfig,
        RerankConfig,
        RetrievalConfig,
        ServeConfig,
        Settings,
    )
    from sentio_tpu_torch.models.tokenizer import HFTokenizer
    from sentio_tpu_torch.pipeline import build_pipeline

    s = _e2e_sections(converted)
    settings = Settings(retrieval=RetrievalConfig(**s["retrieval"]),
                        embedder=EmbedderConfig(**s["embedder"]),
                        rerank=RerankConfig(**s["rerank"]),
                        generator=GeneratorConfig(**s["generator"]),
                        serve=ServeConfig(**serve))
    pipeline = build_pipeline(settings, device="cpu")
    try:
        assert isinstance(pipeline.embedder.tokenizer, HFTokenizer)
        assert isinstance(pipeline.reranker.tokenizer, HFTokenizer)
        assert isinstance(pipeline.replica_set.tokenizer, HFTokenizer)
        if serve.get("replica_mode") == "process":
            assert [w["pid"] for w in pipeline.replica_set.workers()]
        from sentio_tpu_torch.models.document import Document

        pipeline.ingestor.ingest_documents([Document(text=t, id=f"doc{i}", metadata={
            "source": f"d{i}.md"}) for i, t in enumerate(E2E_DOCS)])
        got = pipeline.chat(E2E_QUESTION, mode="fast")
        return got["answer"], got["metadata"]["reranked_ids"]
    finally:
        pipeline.close()


@pytest.fixture(scope="module")
def jax_answer(converted):
    """The JAX container on the same checkpoints and tokenizer directories
    (its paged engine on the CPU, as its own end-to-end test runs it)."""
    from sentio_tpu.config import EmbedderConfig as JE
    from sentio_tpu.config import GeneratorConfig as JG
    from sentio_tpu.config import RerankConfig as JR
    from sentio_tpu.config import RetrievalConfig as JRt
    from sentio_tpu.config import Settings as JS
    from sentio_tpu.serve.dependencies import DependencyContainer

    s = _e2e_sections(converted)
    # JAX's PromptBuilder reads prompts/ from the working directory; the
    # port's from the repo
    cwd = os.getcwd()
    os.chdir(REPO)
    container = DependencyContainer(settings=JS(
        retrieval=JRt(**s["retrieval"]), embedder=JE(**s["embedder"]),
        rerank=JR(**s["rerank"]), generator=JG(**s["generator"])))
    try:
        from sentio_tpu.models.document import Document

        container.ingestor.ingest_documents([Document(text=t, id=f"doc{i}", metadata={
            "source": f"d{i}.md"}) for i, t in enumerate(E2E_DOCS)])
        result = container.chat_handler.process_chat_request_sync(question=E2E_QUESTION,
                                                                   mode="fast")
        assert not result["metadata"]["degraded"], result["metadata"]
        return result["answer"], [s["id"] for s in result["sources"]]
    finally:
        container.cleanup()
        os.chdir(cwd)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_converted_checkpoints_serve_chat_as_jax(converted, jax_answer, mode):
    """``/chat`` through ``build_pipeline`` on the converted generator,
    embedder and cross-encoder with their own tokenizers: the float32
    greedy answer equals the JAX container's, in thread mode and with the
    replica in a worker process."""
    serve = {} if mode == "thread" else dict(replicas=1, replica_mode="process")
    answer, ids = _port_answer(converted, **serve)
    want, want_ids = jax_answer
    assert ids == want_ids and len(ids) == 2
    assert answer and answer == want, (answer, want)


def test_smoke_embedder_tokenizer_matches_jax(converted):
    """The embedder's tokenizer directory ``chip_smoke.py`` writes (XLM-R's
    ``Sequence[Precompiled, Replace]`` normalizer over its own character
    map) against JAX's ``HFTokenizer``: ids, decodes, ``vocab_size`` and
    the five special ids on hard strings and the documents."""
    from test_torch_hf_tokenizer import CORPUS, HARD

    from sentio_tpu.models.tokenizer import HFTokenizer as JaxHFTokenizer
    from sentio_tpu_torch.models.tokenizer import HFTokenizer

    path = converted["tok"]["xlmr"]
    data = json.loads((Path(path) / "tokenizer.json").read_text())
    assert [n["type"] for n in data["normalizer"]["normalizers"]] == ["Precompiled", "Replace"]
    jax_tok, tok = JaxHFTokenizer(path), HFTokenizer(path)
    assert tok.vocab_size == jax_tok.vocab_size
    for name in ("pad_id", "bos_id", "eos_id", "cls_id", "sep_id"):
        assert getattr(tok, name) == getattr(jax_tok, name), name
    for text in HARD + CORPUS[:10] + E2E_DOCS + ["ﬁne  café ①", "a\r\nb\x01c"]:
        for add_bos, add_eos in ((False, False), (True, True)):
            assert tok.encode(text, add_bos=add_bos, add_eos=add_eos) == jax_tok.encode(
                text, add_bos=add_bos, add_eos=add_eos), text
        ids = jax_tok.encode(text)
        assert tok.decode(ids) == jax_tok.decode(ids), text
