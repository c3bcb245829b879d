"""Checkpoint settings (``LLM_CHECKPOINT``, ``RERANKER_CHECKPOINT``, the
``*_TOKENIZER`` paths) in the port against the JAX package.

Checkpoints are written to a temp dir by the JAX package's ``save_pytree``
from weights its init functions make (float32 tiny models), with the meta
``cli convert`` writes. Loaded by each package, they give the same greedy
tokens (exactly) and the same rerank scores (atol 1e-4, float32, as
tests/test_torch_pipeline.py holds them). A checkpoint of the wrong family
raises the JAX ``WeightsError`` message; a ``moe`` checkpoint and any
tokenizer path raise ``NotImplementedError`` naming the setting."""

import dataclasses

import jax
import numpy as np
import pytest

from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import RerankConfig as JRerankConfig
from sentio_tpu.models.cross_encoder import init_cross_encoder
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
from sentio_tpu.runtime.checkpoint import save_pytree
from sentio_tpu.runtime.engine import GeneratorEngine as JEngine
from sentio_tpu.runtime.weights import WeightsError as JWeightsError
from sentio_tpu_torch.config import (
    EmbedderConfig,
    GeneratorConfig,
    RerankConfig,
    Settings,
)
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.embedder import TorchEmbedder
from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.weights import WeightsError

GEN = dict(model_preset="tiny", max_new_tokens=16, dtype="float32")
PROMPTS = ["what does a page table map?", "a", "checkpoints carry their family " * 2]


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ck")
    lcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    ecfg = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    llama = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(31), lcfg))
    ce = jax.tree.map(np.asarray, init_cross_encoder(jax.random.PRNGKey(32), ecfg))
    save_pytree(root / "llama", llama, meta={"family": "llama", "config": lcfg.__dict__})
    save_pytree(root / "ce", ce, meta={"family": "cross-encoder", "config": ecfg.__dict__})
    save_pytree(root / "moe", {"w": np.zeros(2, np.float32)},
                meta={"family": "moe", "config": {"dim": 8}})
    return {name: str(root / name) for name in ("llama", "ce", "moe")}


def test_llm_checkpoint_greedy_tokens_match_jax(checkpoints):
    path = checkpoints["llama"]
    ref = JEngine(config=JGeneratorConfig(checkpoint_path=path, **GEN))
    port = GeneratorEngine(config=GeneratorConfig(checkpoint_path=path, **GEN), device="cpu")
    assert port.model_config.dtype == "float32" and port.model_config.dim == 64
    want = ref.generate(PROMPTS, max_new_tokens=12, temperature=0.0)
    got = port.generate(PROMPTS, max_new_tokens=12, temperature=0.0)
    assert [p.tokens for p in got] == [r.tokens for r in want]
    assert [p.finish_reason for p in got] == [r.finish_reason for r in want]


@pytest.mark.parametrize("paged", [True, False], ids=["paged_service", "contiguous"])
def test_build_pipeline_loads_llm_checkpoint(checkpoints, paged):
    """build_pipeline serves the checkpoint's weights on either engine."""
    path = checkpoints["llama"]
    ref = JEngine(config=JGeneratorConfig(checkpoint_path=path, **GEN))
    settings = Settings(embedder=EmbedderConfig(model_preset="tiny"),
                        generator=GeneratorConfig(checkpoint_path=path, kv_page_size=16,
                                                  kv_max_pages_per_seq=8,
                                                  use_paged_decode=paged, **GEN))
    pipeline = build_pipeline(settings, device="cpu")
    try:
        got = [pipeline.generator.provider.chat(p, max_new_tokens=12, temperature=0.0)
               for p in PROMPTS]
    finally:
        pipeline.close()
    want = [r.text for r in ref.generate(PROMPTS, max_new_tokens=12, temperature=0.0)]
    assert got == want


def test_reranker_checkpoint_scores_match_jax(checkpoints):
    path = checkpoints["ce"]
    texts = ["pages map blocks", "a radix tree of prompts", "unrelated words entirely",
             "slots decode together"]
    ref = JReranker(JRerankConfig(checkpoint_path=path))
    port = CrossEncoderReranker(RerankConfig(checkpoint_path=path), device="cpu")
    want = ref.rerank("what maps blocks to pages?",
                      [JDocument(text=t, id=str(i)) for i, t in enumerate(texts)])
    got = port.rerank("what maps blocks to pages?",
                      [Document(text=t, id=str(i)) for i, t in enumerate(texts)])
    assert not want.fallback_used and not got.fallback_used
    assert [d.id for d in got.documents] == [d.id for d in want.documents]
    np.testing.assert_allclose(got.scores, want.scores, atol=1e-4, rtol=0)


def test_family_mismatch_raises_the_jax_error(checkpoints):
    """A cross-encoder as LLM_CHECKPOINT, a llama as RERANKER_CHECKPOINT."""
    with pytest.raises(JWeightsError) as want:
        JEngine(config=JGeneratorConfig(checkpoint_path=checkpoints["ce"], **GEN))
    with pytest.raises(WeightsError) as got:
        GeneratorEngine(config=GeneratorConfig(checkpoint_path=checkpoints["ce"], **GEN),
                        device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(JWeightsError) as want:
        JReranker(JRerankConfig(checkpoint_path=checkpoints["llama"]))
    with pytest.raises(WeightsError) as got:
        CrossEncoderReranker(RerankConfig(checkpoint_path=checkpoints["llama"]), device="cpu")
    assert str(got.value) == str(want.value)


def test_moe_checkpoint_raises_naming_the_setting(checkpoints):
    with pytest.raises(NotImplementedError, match="LLM_CHECKPOINT"):
        GeneratorEngine(config=GeneratorConfig(checkpoint_path=checkpoints["moe"], **GEN),
                        device="cpu")
    settings = Settings(embedder=EmbedderConfig(model_preset="tiny"),
                        generator=GeneratorConfig(checkpoint_path=checkpoints["moe"], **GEN))
    with pytest.raises(NotImplementedError, match="LLM_CHECKPOINT"):
        build_pipeline(settings, device="cpu")


@pytest.mark.parametrize("setting", ["LLM_TOKENIZER", "RERANKER_TOKENIZER",
                                     "EMBEDDER_TOKENIZER"])
def test_tokenizer_paths_raise_naming_the_setting(monkeypatch, setting):
    monkeypatch.setenv(setting, "/nonexistent/hf-tokenizer")
    settings = Settings.from_env()
    settings.embedder = dataclasses.replace(settings.embedder, model_preset="tiny")
    settings.generator = dataclasses.replace(settings.generator, model_preset="tiny")
    with pytest.raises(NotImplementedError, match=setting):
        build_pipeline(settings, device="cpu")
    if setting == "RERANKER_TOKENIZER":
        with pytest.raises(NotImplementedError, match=setting):
            CrossEncoderReranker(settings.rerank, device="cpu")
    if setting == "EMBEDDER_TOKENIZER":
        with pytest.raises(NotImplementedError, match=setting):
            TorchEmbedder(settings.embedder, device="cpu")
