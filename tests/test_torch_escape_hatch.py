"""The paged path's contiguous escape hatch (``ops/generator.py::
EngineProvider``) against JAX's ``TpuProvider``, and ``INDEX_BACKEND``.

The same fake replica tier stands in front of each package's provider,
each over its own tiny contiguous engine on shared float32 weights (made by
the JAX init, carried by ``sentio_tpu_torch.runtime.weights``). Where the
tier gives an ``error`` result, raises a plain ``RuntimeError``, or a
stream dies before its first piece, both providers answer from their
contiguous engine with equal greedy text; a ``soft_fail_exempt`` error
(shed, expired deadline) and a stream that dies after its first piece make
both raise. ``build_pipeline`` gives the paged provider its contiguous
engine on the same weight tensors, and a live tiny pipeline whose paged
ticks fail with no failover budget answers from it. ``INDEX_BACKEND``:
``qdrant`` is refused as not ported, an unknown name raises the port's
``VectorStoreError`` with the message JAX's registry raises."""

import dataclasses

import jax
import numpy as np
import pytest

from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.infra import exceptions as jexc
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.ops.generator import TpuProvider
from sentio_tpu.ops.vector_store import VectorStoreError as JVectorStoreError
from sentio_tpu.ops.vector_store import get_vector_store
from sentio_tpu.runtime.engine import GeneratorEngine as JEngine
from sentio_tpu_torch.config import (
    GeneratorConfig,
    RetrievalConfig,
    ServeConfig,
    Settings,
)
from sentio_tpu_torch.infra import exceptions as texc
from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.infra.exceptions import VectorStoreError
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.ops.generator import EngineProvider
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.weights import llama_from_jax

GEN = dict(model_preset="tiny", max_new_tokens=12, max_prompt_tokens=4096, dtype="float32")
PROMPT = "what does the escape hatch answer with"
MAX_NEW = 12
# the fault point a paged tick hits first (named through a constant: the
# JAX package's fault-point inventory reads literal names armed in tests)
STEP = "paged.step"


@dataclasses.dataclass
class FakeResult:
    text: str = ""
    finish_reason: str = "error"
    tokens: tuple = ()

    def stats_dict(self) -> dict:
        return {"tokens": len(self.tokens)}


class FakeTier:
    """A replica tier that fails as told: ``error`` (an error result),
    ``raise`` (a plain RuntimeError), ``soft`` (the package's own shed),
    ``deadline`` (its expired deadline), ``stream_early`` (a stream that
    dies before its first piece), ``stream_late`` (after one piece)."""

    def __init__(self, mode: str, package) -> None:
        self.mode, self.package = mode, package
        self.calls = 0

    def _raise(self):
        if self.mode == "soft":
            raise self.package.ServiceOverloaded("decode queue full", status=429)
        if self.mode == "deadline":
            raise self.package.DeadlineExceededError("deadline expired before submit")
        raise RuntimeError("tier down")

    def generate(self, prompt, **kwargs):
        self.calls += 1
        if self.mode == "error":
            return FakeResult()
        self._raise()

    def generate_stream(self, prompt, **kwargs):
        self.calls += 1
        if self.mode == "stream_late":
            yield "partial "
        self._raise()


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(31), jcfg))
    ref = JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, params=tree)
    port = GeneratorEngine(config=GeneratorConfig(**GEN),
                           model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                           params=llama_from_jax(tree), device="cpu")
    return ref, port


def providers(engines, mode):
    ref, port = engines
    jtier, ttier = FakeTier(mode, jexc), FakeTier(mode, texc)
    return (TpuProvider(engine=ref, service=jtier), jtier,
            EngineProvider(contiguous=port, service=ttier), ttier)


@pytest.mark.parametrize("mode", ["error", "raise"])
def test_chat_falls_back_as_jax(engines, mode):
    jprov, jtier, tprov, ttier = providers(engines, mode)
    want = jprov.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)
    got = tprov.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)
    assert got == want
    assert got == engines[1].generate([PROMPT], max_new_tokens=MAX_NEW,
                                      temperature=0.0)[0].text
    assert jtier.calls == ttier.calls == 1


def test_stream_falls_back_before_its_first_piece_as_jax(engines):
    jprov, _, tprov, _ = providers(engines, "stream_early")
    want = "".join(jprov.stream(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0))
    got = "".join(tprov.stream(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0))
    assert got == want and got


@pytest.mark.parametrize("mode", ["soft", "deadline"])
def test_soft_fail_exempt_errors_raise_as_jax(engines, mode):
    jprov, _, tprov, _ = providers(engines, mode)
    for prov, package in ((jprov, jexc), (tprov, texc)):
        with pytest.raises(package.SentioError) as info:
            prov.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)
        assert info.value.soft_fail_exempt
        with pytest.raises(package.SentioError):
            list(prov.stream(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0))


def test_a_stream_that_delivered_raises_as_jax(engines):
    jprov, _, tprov, _ = providers(engines, "stream_late")
    for prov in (jprov, tprov):
        pieces = []
        with pytest.raises(RuntimeError, match="tier down"):
            for piece in prov.stream(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0):
                pieces.append(piece)
        assert pieces == ["partial "]


@pytest.mark.parametrize("mode", ["error", "raise"])
def test_without_a_contiguous_engine_both_raise(mode):
    jtier, ttier = FakeTier(mode, jexc), FakeTier(mode, texc)
    for prov in (TpuProvider(service=jtier), EngineProvider(service=ttier)):
        with pytest.raises(RuntimeError):
            prov.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)


def test_the_escape_hatch_is_never_the_speculative_decoder(engines):
    class Refuse:
        def generate(self, *a, **k):
            raise AssertionError("the paged path's fallback must not speculate")

    prov = EngineProvider(contiguous=engines[1], service=FakeTier("error", texc),
                          speculative=Refuse())
    assert prov.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)


def tiny_settings(**serve) -> Settings:
    return Settings(
        retrieval=RetrievalConfig(strategy="dense"),
        generator=GeneratorConfig(model_preset="tiny", max_new_tokens=MAX_NEW,
                                  verifier_max_tokens=8, kv_page_size=16,
                                  kv_max_pages_per_seq=32, max_batch_size=2,
                                  decode_steps_per_tick=4, decode_max_tick_steps=4,
                                  dtype="float32"),
        serve=ServeConfig(replica_supervise=False, **serve))


def test_build_pipeline_gives_the_paged_provider_its_contiguous_engine():
    pipeline = build_pipeline(tiny_settings(), device="cpu", seed=3)
    try:
        provider = pipeline.generator.provider
        assert isinstance(provider.contiguous, GeneratorEngine)
        assert provider.service is pipeline.replica_set and provider.speculative is None
        paged = pipeline.replica_set.services[0].engine
        # one set of weight tensors: the escape hatch holds no copy
        assert provider.contiguous.params["embed_tokens"] is paged.params["embed_tokens"]
    finally:
        pipeline.close()


def test_failing_paged_ticks_are_answered_by_the_contiguous_engine():
    """Every paged tick fails (the crash retry too) and no failover budget
    is left: the tier's ``error`` result makes the provider answer from the
    contiguous engine, greedy-equal to the paged engine's own answer."""
    pipeline = build_pipeline(tiny_settings(replica_failover_budget=0), device="cpu", seed=3)
    provider = pipeline.generator.provider
    try:
        reference = provider.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)
        rule = faults.FaultRule(error=RuntimeError("injected tick failure"), times=2)
        faults.arm(STEP, rule)
        try:
            got = provider.chat(PROMPT, max_new_tokens=MAX_NEW, temperature=0.0)
        finally:
            faults.disarm(STEP)
        assert rule.fired == 2
        assert got == reference
        assert got == provider.contiguous.generate([PROMPT], max_new_tokens=MAX_NEW,
                                                   temperature=0.0)[0].text
        assert pipeline.replica_set.services[0].stats()["tick_failures"] == 2
    finally:
        pipeline.close()


def test_index_backend_qdrant_is_refused():
    settings = tiny_settings()
    settings.retrieval = dataclasses.replace(settings.retrieval, index_backend="qdrant")
    with pytest.raises(NotImplementedError, match="INDEX_BACKEND=qdrant"):
        build_pipeline(settings, device="cpu")


def test_unknown_index_backend_raises_as_jax():
    settings = tiny_settings()
    settings.retrieval = dataclasses.replace(settings.retrieval, index_backend="bogus")
    with pytest.raises(VectorStoreError) as got:
        build_pipeline(settings, device="cpu")
    with pytest.raises(JVectorStoreError) as want:
        get_vector_store("bogus", dim=8)
    assert str(got.value) == str(want.value)


def test_index_backend_env_reaches_the_refusal(monkeypatch):
    for name in ("INDEX_BACKEND", "VECTOR_STORE"):
        monkeypatch.setenv(name, "bogus")
        with pytest.raises(VectorStoreError):
            build_pipeline(Settings.from_env(), device="cpu")
        monkeypatch.delenv(name)
