"""Speculation inside the port's paged engine (``runtime/paged_spec.py``)
against the JAX engine's (``sentio_tpu/runtime/paged_spec.py``), case for
case with ``tests/test_paged_spec.py``.

Target and draft are float32 tiny Llamas made by the JAX init functions and
carried across with ``runtime/weights.py``, so greedy rows are token-exact:
the port's spec tokens equal the JAX engine's spec tokens and the port's own
plain-engine tokens, with the same finish reasons, and the verify and
emitted counts (``spec_verifies``, ``spec_emitted``) equal JAX's exactly.
Greedy cases run at pipeline depth 1 and 2. The int8 pool after a run is
held to JAX's pool: codes within one step of rounding and scales within one
f16 ulp (float32 K/V agree to ~1e-6 before quantization, as
tests/test_torch_kv_quant.py holds a decode step's writes); the round trip
of a tick with nothing to decode is exact. Sampled rows draw from torch's
generator, so they are held to completion and seed determinism here and by
distribution in tests/test_torch_speculative.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import Settings as JSettings
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.checkpoint import save_pytree
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JEngine
from sentio_tpu.runtime.paged import quantize_kv as jax_quantize
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu.runtime.weights import WeightsError as JWeightsError
from sentio_tpu.runtime.weights import load_model as jax_load_model
from sentio_tpu.serve.app import _speculative_info
from sentio_tpu.serve.dependencies import DependencyContainer
from sentio_tpu_torch.config import EmbedderConfig, GeneratorConfig, RerankConfig, Settings
from sentio_tpu_torch.infra.metrics import get_metrics
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.service import PagedGenerationService
from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder
from sentio_tpu_torch.runtime.weights import WeightsError, llama_from_jax
from sentio_tpu_torch.serve.app import publish_serving_gauges

ENGINE_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=8)
PROMPTS = ["speculate on this prompt", "another about mxu arrays", "third request",
           "and a fourth"]
DEPTHS = [1, 2]


@pytest.fixture(scope="module")
def stack():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    jdcfg = dataclasses.replace(
        JLlamaConfig(vocab_size=jcfg.vocab_size, dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
                     mlp_dim=64, max_len=jcfg.max_len), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(0), jcfg))
    dtree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(7), jdcfg))
    otree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(999), jcfg))
    cfg, dcfg = LlamaConfig(**dataclasses.asdict(jcfg)), LlamaConfig(**dataclasses.asdict(jdcfg))
    return {"jax": (jcfg, tree, jdcfg, dtree), "jax_other": otree,
            "port": (cfg, llama_from_jax(tree), dcfg, llama_from_jax(dtree)),
            "port_other": llama_from_jax(otree)}


def make(stack, side, draft="weak", spec_k=4, **kw):
    """An engine of ``side`` ("jax" or "port"): the draft is "weak" (a
    smaller model: dim 32, one layer), "other" (the target's geometry with
    other weights), "perfect" (the target's own tensors) or None."""
    cfg, params, dcfg, dparams = stack[side]
    kw = {**ENGINE_KW, **kw}
    if draft is not None:
        if draft == "perfect":
            dcfg, dparams = cfg, params
        elif draft == "other":
            dcfg, dparams = cfg, stack[f"{side}_other"]
        kw.update(draft_params=dparams, draft_config=dcfg, spec_k=spec_k)
    if side == "jax":
        return JEngine(model_config=cfg, params=params, **kw)
    return ContinuousBatchingEngine(model_config=cfg, params=params, device="cpu", **kw)


def drain(engine, requests):
    """Submit ``requests`` ([(prompt, max_new, temperature)]) and step until
    idle → results in submit order."""
    ids = [engine.submit(p, n, t) for p, n, t in requests]
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    return [done[i] for i in ids]


def assert_same(want, got):
    assert [(g.tokens, g.finish_reason, g.prompt_tokens) for g in got] == \
        [(w.tokens, w.finish_reason, w.prompt_tokens) for w in want]


def spec_counts(engine):
    return engine.spec_verifies_total, engine.spec_emitted_total


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("draft", ["weak", "other", "perfect"])
def test_greedy_matches_jax_and_the_plain_engine(stack, draft, depth):
    """ignore_eos, 24 tokens a row: the port's spec tokens equal JAX's spec
    tokens and the port's plain tokens; verify and emitted counts equal
    JAX's. A perfect draft accepts almost everything (tick budgets cut
    rounds, so it stays under k+1)."""
    requests = [(p, 24, 0.0) for p in PROMPTS]
    plain = drain(make(stack, "port", None, ignore_eos=True, pipeline_depth=depth), requests)
    ref = make(stack, "jax", draft, ignore_eos=True, pipeline_depth=depth)
    port = make(stack, "port", draft, ignore_eos=True, pipeline_depth=depth)
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert_same(plain, got)
    assert spec_counts(port) == spec_counts(ref)
    assert port.stats()["spec_tokens_per_verify"] == ref.stats()["spec_tokens_per_verify"]
    # spec results carry no logprob accumulators, as in JAX
    assert [g.logprob_count for g in got] == [w.logprob_count for w in want] == [0] * 4
    assert port.total_sub_steps == port.spec_emitted_total
    if draft == "perfect":
        assert port.stats()["spec_tokens_per_verify"] > 2.0


@pytest.mark.parametrize("depth", DEPTHS)
def test_eos_semantics_match(stack, depth):
    """EOS honoured: each row stops where the plain engine and JAX's spec
    engine stop, with the same finish reasons."""
    requests = [(p, 24, 0.0) for p in PROMPTS]
    plain = drain(make(stack, "port", None, pipeline_depth=depth), requests)
    ref = make(stack, "jax", pipeline_depth=depth)
    port = make(stack, "port", pipeline_depth=depth)
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert_same(plain, got)
    assert spec_counts(port) == spec_counts(ref)


@pytest.mark.parametrize("depth", DEPTHS)
def test_continuous_batching_waves(stack, depth):
    """10 requests of varied budgets through 3 slots: rows join and leave
    across ticks and the tokens stay the plain engine's and JAX's."""
    requests = [(f"wave request number {i} about pallas", 8 + (i * 5) % 20, 0.0)
                for i in range(10)]
    kw = dict(max_slots=3, ignore_eos=True, pipeline_depth=depth)
    plain = drain(make(stack, "port", None, **kw), requests)
    ref, port = make(stack, "jax", spec_k=3, **kw), make(stack, "port", spec_k=3, **kw)
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert_same(plain, got)
    assert spec_counts(port) == spec_counts(ref)


@pytest.mark.parametrize("steps", [2, 3])
def test_budget_ends_mid_round(stack, steps):
    """Ticks of 2 or 3 steps with a perfect draft at k 4: every round would
    emit 5 tokens, so each tick's budget ends mid-round and the surplus is
    decoded again next tick. Tokens and counts stay exact; the token write
    of a round is never shifted."""
    requests = [(p, 13, 0.0) for p in PROMPTS[:3]]
    kw = dict(ignore_eos=True, steps_per_tick=steps, max_tick_steps=steps)
    plain = drain(make(stack, "port", None, **kw), requests)
    ref, port = make(stack, "jax", "perfect", **kw), make(stack, "port", "perfect", **kw)
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert_same(plain, got)
    assert spec_counts(port) == spec_counts(ref)
    assert all(len(g.tokens) == 13 for g in got)


def test_prefix_cache_composes(stack):
    """A warmed header: both prompts hit it (the draft still prefills the
    whole prompt), and the tokens stay the plain engine's."""
    header = "System header: be terse and cite. "
    requests = [(header + q, 16, 0.0) for q in ("what is a mesh?", "why bfloat16?")]
    plain = drain(make(stack, "port", None, ignore_eos=True), requests)
    ref, port = make(stack, "jax", ignore_eos=True), make(stack, "port", ignore_eos=True)
    assert port.warm_prefix(header) == ref.warm_prefix(header) > 0
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert_same(plain, got)
    assert port.prefix_hits == ref.prefix_hits == 2
    assert spec_counts(port) == spec_counts(ref)


def test_int8_pool_matches_jax(stack):
    """KV_QUANT=int8: each tick dequantizes every page into the dense cache
    and quantizes it back. The tokens equal JAX's spec engine's; the pools
    after the run agree code for code within one rounding step and scale
    for scale within one f16 ulp, and all but a small share of the codes
    are equal. Scratch page 0 is left out: free rows write their junk there
    in both engines, each in its own order."""
    requests = [(p, 16, 0.0) for p in PROMPTS[:2]]
    ref = make(stack, "jax", ignore_eos=True, kv_quant="int8")
    port = make(stack, "port", ignore_eos=True, kv_quant="int8")
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert all(len(g.tokens) == 16 for g in got)
    assert spec_counts(port) == spec_counts(ref)
    flips = total = 0
    for mine, theirs in ((port.pool.k, ref.pool.k), (port.pool.v, ref.pool.v)):
        dq = (mine.q.numpy()[:, 1:].astype(np.int32)
              - np.asarray(theirs["q"])[:, 1:].astype(np.int32))
        assert np.abs(dq).max() <= 1
        flips, total = flips + int((dq != 0).sum()), total + dq.size
        np.testing.assert_allclose(mine.s.numpy()[:, 1:].astype(np.float32),
                                   np.asarray(theirs["s"])[:, 1:].astype(np.float32),
                                   rtol=2.0 ** -10, atol=0)
    assert flips <= total // 1000, (flips, total)


def test_int8_round_trip_is_exact_in_float32(stack):
    """A spec tick dequantizes every page into the dense cache and
    quantizes it back: in float32 every code and scale of the pages wholly
    before the tick's first write (a row's length) comes back bit for bit.
    One round at length 100 of the 128-token window writes nothing before
    position 96, so the first 6 pages of each row are held exactly (what
    chip_smoke.py reports on the card in bf16)."""
    cfg = stack["port"][0]
    port = make(stack, "port", kv_quant="int8")
    rng = np.random.default_rng(5)
    shape = port.pool.k.q.shape[:-1] + (cfg.head_dim,)
    for pages in (port.pool.k, port.pool.v):
        q, s = jax_quantize(jnp.asarray(rng.standard_normal(shape), jnp.float32))
        pages.q.copy_(torch.from_numpy(np.array(q)))
        pages.s.copy_(torch.from_numpy(np.array(s)))
    before = [(p.q.clone(), p.s.clone()) for p in (port.pool.k, port.pool.v)]
    st, spec = port._st, port._ensure_spec()
    table = torch.arange(1, 33, dtype=torch.int32).reshape(4, 8)
    st.table.copy_(table)
    st.lens.fill_(100)
    st.budgets.fill_(2)
    spec.begin(st, port.pool)
    spec.round(st, True, None)
    spec.end(st, port.pool)
    assert spec.rounds.tolist() == [1] * 4 and bool((spec.emitted >= 1).all())
    kept = table[:, :6].reshape(-1).long()
    for (q0, s0), pages in zip(before, (port.pool.k, port.pool.v)):
        assert torch.equal(pages.q[:, kept], q0[:, kept])
        assert torch.equal(pages.s[:, kept].view(torch.int16), s0[:, kept].view(torch.int16))
        assert not torch.equal(pages.q, q0)  # the round wrote past length 100


def test_long_prompt_bucket_exceeding_draft_window(stack):
    """A 73-token prompt buckets its prefill to width 128, past the 96-token
    window of max_pages_per_seq=6: the draft prefill is clamped to the
    window, and the tokens equal the plain engine's."""
    requests = [("overrun " * 9, 4, 0.0)]
    plain = drain(make(stack, "port", None, ignore_eos=True, max_pages_per_seq=6), requests)
    ref = make(stack, "jax", ignore_eos=True, max_pages_per_seq=6)
    port = make(stack, "port", ignore_eos=True, max_pages_per_seq=6)
    want, got = drain(ref, requests), drain(port, requests)
    assert_same(want, got)
    assert_same(plain, got)
    assert got[0].finish_reason in ("stop", "length")


def test_sampled_and_mixed_batches_complete_and_are_seeded(stack):
    """Sampled rows (rejection sampling) and greedy rows share ticks: every
    row gets its 12 tokens, the greedy rows the plain engine's, and two
    engines made from one seed give the same sampled tokens."""
    requests = [(PROMPTS[i], 12, 0.0 if i % 2 else 0.8) for i in range(4)]
    runs = [drain(make(stack, "port", ignore_eos=True, rng_seed=3), requests)
            for _ in range(2)]
    assert [r.tokens for r in runs[0]] == [r.tokens for r in runs[1]]
    assert all(len(r.tokens) == 12 for r in runs[0])
    plain = drain(make(stack, "port", None, ignore_eos=True), requests[1::2])
    assert [r.tokens for r in runs[0][1::2]] == [r.tokens for r in plain]
    other = drain(make(stack, "port", ignore_eos=True, rng_seed=4), requests)
    assert [r.tokens for r in other[::2]] != [r.tokens for r in runs[0][::2]]


def test_sampled_rows_at_a_tiny_temperature_are_greedy(stack):
    """Rows at temperature 1e-5 take the sampled rule (draft draws, the
    draft's and the target's distributions, rejection and the residual)
    beside a greedy row: every draw is then the argmax almost surely, so
    all rows give the plain engine's greedy tokens."""
    requests = [(p, 16, 1e-5 if i % 2 else 0.0) for i, p in enumerate(PROMPTS)]
    plain = drain(make(stack, "port", None, ignore_eos=True),
                  [(p, n, 0.0) for p, n, _t in requests])
    got = drain(make(stack, "port", ignore_eos=True), requests)
    assert [r.tokens for r in got] == [r.tokens for r in plain]


@pytest.mark.parametrize("case", ["vocab", "chunked", "no_config"])
def test_validation_raises_the_jax_error(stack, case):
    jcfg, tree, jdcfg, dtree = stack["jax"]
    cfg, params, dcfg, dparams = stack["port"]
    jkw, kw = {
        "vocab": (dict(draft_params=dtree,
                       draft_config=dataclasses.replace(jdcfg, vocab_size=1024)),
                  dict(draft_params=dparams,
                       draft_config=dataclasses.replace(dcfg, vocab_size=1024))),
        "chunked": (dict(draft_params=dtree, draft_config=jdcfg, prefill_chunk=16),
                    dict(draft_params=dparams, draft_config=dcfg, prefill_chunk=16)),
        "no_config": (dict(draft_params=dtree), dict(draft_params=dparams)),
    }[case]
    with pytest.raises(ValueError) as want:
        JEngine(model_config=jcfg, params=tree, **ENGINE_KW, **jkw)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(model_config=cfg, params=params, device="cpu", **ENGINE_KW,
                                 **kw)
    assert str(got.value) == str(want.value)


def test_top_k_refused_at_the_engine_and_the_service(stack):
    """top_k > 0 with a draft raises JAX's ValueError at ``submit`` and at
    the service's ``generate`` / ``generate_stream``, before anything is
    queued; top_k 0 is served."""
    ref, port = make(stack, "jax"), make(stack, "port")
    with pytest.raises(ValueError) as want:
        ref.submit("x", 4, 0.7, top_k=5)
    with pytest.raises(ValueError) as got:
        port.submit("x", 4, 0.7, top_k=5)
    assert str(got.value) == str(want.value)
    jservice, service = JService(ref), PagedGenerationService(port, default_timeout_s=60)
    try:
        with pytest.raises(ValueError) as want:
            jservice.generate("x", max_new_tokens=4, temperature=0.7, top_k=5)
        with pytest.raises(ValueError) as got:
            service.generate("x", max_new_tokens=4, temperature=0.7, top_k=5)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="top_k"):
            next(service.generate_stream("x", max_new_tokens=4, temperature=0.7, top_k=5))
        assert service.backlog() == 0
        assert len(service.generate("x", max_new_tokens=4, top_k=0).tokens) <= 4
    finally:
        jservice.close()
        service.close()


def test_service_shares_spec_ticks(stack):
    """4 callers at once through the service: the rows share spec ticks and
    each gets the plain engine's greedy tokens; the warmup admits its
    shapes without the top-k request."""
    import threading

    port = make(stack, "port", ignore_eos=True)
    service = PagedGenerationService(port, default_timeout_s=60)
    results = {}

    def call(i):
        results[i] = service.generate(PROMPTS[i], max_new_tokens=16)

    try:
        assert service.warmup()["prompts"] > 0
        verifies = port.spec_verifies_total
        threads = [threading.Thread(target=call, args=(i,), name=f"spec-caller-{i}")
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        plain = drain(make(stack, "port", None, ignore_eos=True),
                      [(p, 16, 0.0) for p in PROMPTS])
        assert [results[i].tokens for i in range(4)] == [r.tokens for r in plain]
        assert service.stats()["shared_ticks"] > 0
        assert port.spec_verifies_total > verifies
    finally:
        service.close()


# ------------------------------------------------------------ the pipeline


def _draft_checkpoint(stack, tmp_path, family="llama"):
    _jcfg, _tree, jdcfg, dtree = stack["jax"]
    path = tmp_path / f"draft-{family}"
    save_pytree(path, dtree, meta={"family": family, "config": dataclasses.asdict(jdcfg)})
    return str(path)


def _settings(**gen):
    return Settings(embedder=EmbedderConfig(model_preset="tiny"),
                    rerank=RerankConfig(enabled=False),
                    generator=GeneratorConfig(model_preset="tiny", dtype="float32",
                                              use_verifier=False, max_new_tokens=10,
                                              kv_page_size=16, kv_max_pages_per_seq=8,
                                              max_batch_size=2, **gen))


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "contiguous"])
def test_draft_checkpoint_activates_speculation(stack, tmp_path, paged):
    """LLM_DRAFT_CHECKPOINT written by JAX's saver: build_pipeline loads it
    and speculates — in the paged engine's ticks under USE_PAGED_KV=1, in a
    SpeculativeDecoder under USE_PAGED_KV=0 — and a greedy chat gives the
    same text as the pipeline without the draft."""
    cfg, params = stack["port"][:2]
    ck = _draft_checkpoint(stack, tmp_path)
    kw = dict(llama_config=cfg, llama_params=params, device="cpu")
    pipeline = build_pipeline(_settings(draft_checkpoint_path=ck, speculative_k=3,
                                        use_paged_decode=paged), **kw)
    plain = build_pipeline(_settings(use_paged_decode=paged), **kw)
    try:
        provider = pipeline.generator.provider
        prompt = "one request through the spec path"
        answer = pipeline.generator.chat_raw(prompt, 10, 0.0)
        assert answer == plain.generator.chat_raw(prompt, 10, 0.0)
        if paged:
            assert provider.engine.draft_params is not None and provider.engine.spec_k == 3
            assert provider.engine.spec_verifies_total > 0
            # the spec stats reach the service's stats and /metrics
            stats = publish_serving_gauges(pipeline)
            assert stats["spec_verifies"] == provider.engine.spec_verifies_total
            assert 1.0 <= stats["spec_tokens_per_verify"] <= 4.0
            assert 'stat="spec_tokens_per_verify"' in get_metrics().export_prometheus().decode()
        else:
            assert isinstance(provider.speculative, SpeculativeDecoder)
            assert provider.speculative.k == 3 and provider.speculative.stats["rounds"] > 0
        assert pipeline.speculative_info == {"draft_configured": True, "active": True}
    finally:
        pipeline.close()
        plain.close()


def test_draft_checkpoint_refusals_name_the_setting(stack, tmp_path):
    """A draft checkpoint of another family is refused with JAX's message
    after the setting's name."""
    ck = _draft_checkpoint(stack, tmp_path, family="cross-encoder")
    with pytest.raises(JWeightsError) as want:
        jax_load_model(ck, expect_family="llama")
    with pytest.raises(WeightsError) as got:
        build_pipeline(_settings(draft_checkpoint_path=ck), device="cpu")
    assert str(got.value) == f"LLM_DRAFT_CHECKPOINT: {want.value}"


SPEC_SETTINGS = {
    "no_draft": dict(),
    "paged_active": dict(draft=True),
    "prefill_chunk": dict(draft=True, prefill_chunk=32),
    "contiguous_active": dict(draft=True, use_paged_decode=False, prefill_chunk=32),
}


@pytest.mark.parametrize("name", sorted(SPEC_SETTINGS))
def test_info_speculative_matches_jax(stack, tmp_path, name):
    """/info's generator.speculative: the port's pipeline against JAX's
    ``_speculative_info`` for the same settings (a single-chip container),
    and the port's /info serves it."""
    import http.client
    import json
    import threading

    from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
    from sentio_tpu_torch.serve.app import create_server

    kw = dict(SPEC_SETTINGS[name])
    ck = _draft_checkpoint(stack, tmp_path) if kw.pop("draft", False) else ""
    jsettings = JSettings()
    jsettings.generator = JGeneratorConfig(provider="tpu", draft_checkpoint_path=ck, **kw)
    want = _speculative_info(DependencyContainer(settings=jsettings, mesh=None,
                                                 engine=object()))
    cfg, params = stack["port"][:2]
    pipeline = build_pipeline(_settings(draft_checkpoint_path=ck, **kw), device="cpu",
                              llama_config=cfg, llama_params=params)
    server = create_server(None, pipeline, host="127.0.0.1", port=0,
                           fallback=(FallbackResponseCache(str(tmp_path / "fallback")),
                                     LLMFallback()))
    thread = threading.Thread(target=server.serve_forever, name="info-server", daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1], timeout=60)
        conn.request("GET", "/info")
        info = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
        pipeline.close()
    assert not thread.is_alive()
    assert pipeline.speculative_info == want
    assert info["generator"]["speculative"] == want
    engine = pipeline.generator.provider.engine
    if pipeline.service is not None:
        assert (engine.draft_params is not None) == want["active"]
