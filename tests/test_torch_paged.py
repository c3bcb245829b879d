"""The port's paged continuous-batching engine against the JAX engine.

Both engines share one set of float32 tiny-Llama weights (made by the JAX
init, carried by sentio_tpu_torch.runtime.weights). The JAX engine runs its
Pallas paged kernel in interpret mode (use_pallas=True — off the TPU it
would otherwise take its XLA gather path). Each case runs in the four
engine configurations (prefix_cache, pipeline_depth, prefill_chunk) of
:data:`CONFIGS`, from the cache off up to the serving defaults plus
chunked prefill. Greedy output must be token-exact, with the same finish
reasons, prompt lengths and prefix-hit / prefill token counts; the
logprob accumulators agree within 1e-4 (float32 log-softmax of logits
that agree to ~1e-6). Temperature sampling draws from different
generators (threefry vs Philox), so it is compared by distribution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JaxEngine
from sentio_tpu.runtime.sampling import sample_tokens as jax_sample
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla
from sentio_tpu_torch.runtime.sampling import sample_tokens
from sentio_tpu_torch.runtime.weights import llama_from_jax
from _sanitize import _sanitized  # noqa: F401  (arms the module)


MAX_NEW = 24
ENGINE_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=8)
# (prefix_cache, pipeline_depth, prefill_chunk)
CONFIGS = [(False, 1, None), (True, 1, None), (True, 2, None), (True, 2, 32)]
CONFIG_IDS = ["plain", "prefix", "prefix_depth2", "prefix_depth2_chunk32"]

HEAD = "You answer from the numbered sources below and cite them. " * 2
PROMPT_SETS = {
    "single": ["paged equivalence check"],
    "mixed_lengths": ["a", "a much longer prompt that spans several pages of cache " * 2,
                      "mid size prompt"],
    # more requests than the 4 slots: the rest admit as slots retire, and
    # the later ones match the heads the earlier ones inserted
    "more_than_slots": [f"request number {i} " * (i % 3 + 1) for i in range(7)],
    "shared_heads": [HEAD + q for q in ("what is a page?", "who owns a slot?",
                                        "why a radix tree?", "where is scratch?",
                                        "how do ticks pipeline?")],
}


def _config_kw(config):
    prefix_cache, depth, chunk = config
    return dict(prefix_cache=prefix_cache, pipeline_depth=depth, prefill_chunk=chunk)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(11), jcfg))
    return jcfg, tree


def make_engines(weights, config, kv_quant="none", **kw):
    """A JAX engine and a port engine on the same weights and settings."""
    jcfg, tree = weights
    kw = {**ENGINE_KW, **_config_kw(config), "kv_quant": kv_quant, **kw}
    ref = JaxEngine(model_config=jcfg, params=tree, use_pallas=True, **kw)
    port = ContinuousBatchingEngine(model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                                    params=llama_from_jax(tree), device="cpu", **kw)
    return ref, port


@pytest.fixture(scope="module", params=CONFIGS, ids=CONFIG_IDS)
def engines(request, weights):
    return make_engines(weights, request.param)


def _drain(engine):
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    return done


def assert_same(ref_results, port_results, ref=None, port=None):
    """Token-exact results; with the engines, equal prefill/hit totals."""
    assert len(ref_results) == len(port_results)
    for r, p in zip(ref_results, port_results):
        assert p.tokens == r.tokens
        assert p.text == r.text
        assert p.finish_reason == r.finish_reason
        assert p.prompt_tokens == r.prompt_tokens
        assert (p.prefill_tokens, p.prefix_hit_tokens) == (r.prefill_tokens,
                                                           r.prefix_hit_tokens)
        assert p.prefill_tokens + p.prefix_hit_tokens == p.prompt_tokens
        assert p.logprob_count == r.logprob_count
        np.testing.assert_allclose([p.logprob_sum, p.logprob_min],
                                   [r.logprob_sum, r.logprob_min], atol=1e-4, rtol=0)
    if ref is not None:
        assert port.prefill_tokens_total == ref.prefill_tokens_total
        assert port.prefix_hit_tokens_total == ref.prefix_hit_tokens_total
        assert (port.prefix_hits, port.prefix_misses) == (ref.prefix_hits, ref.prefix_misses)


def run_staggered(engine, waves, max_new=MAX_NEW):
    """Submit each wave, take one step, and drain at the end: requests join
    while others decode (or prefill in segments)."""
    ids, done = [], {}
    for wave in waves:
        ids += [engine.submit(p, max_new, 0.0) for p in wave]
        for r in engine.step():
            done[r.request_id] = r
    done.update(_drain(engine))
    return [done[i] for i in ids]


@pytest.mark.parametrize("name", sorted(PROMPT_SETS))
def test_greedy_token_exact(engines, name):
    ref, port = engines
    prompts = PROMPT_SETS[name]
    assert_same(ref.run_all(prompts, max_new_tokens=MAX_NEW, temperature=0.0),
                port.run_all(prompts, max_new_tokens=MAX_NEW, temperature=0.0), ref, port)


def test_staggered_arrivals_token_exact(engines):
    """Requests join while others decode: same admission ticks on both."""
    waves = (["first arrival"], ["second, a bit later", "third"], ["last one in"],
             [HEAD + "late joiner with the shared head"])
    assert_same(*(run_staggered(e, waves) for e in engines), *engines)


def test_verify_prompt_reuses_generate_prompt(engines):
    """The chat pattern: the verify prompt embeds the generate prompt
    verbatim as its head, so with the cache on verify prefills only what
    follows the generate prompt's full pages."""
    ref, port = engines
    # short enough that the verify prompt keeps all of it inside the
    # 128-token window (the prompt keeps at most 128 - (24 + 2) tokens)
    generate = "[1] Source: notes.md\nPages hold sixteen tokens each.\nQ: what is a page?"
    results = []
    for engine in engines:
        gen = engine.run_all([generate], max_new_tokens=MAX_NEW)[0]
        verify = generate + "\nAnswer: " + gen.text + "\nAudit the answer as JSON."
        before = engine.prefix_hit_tokens_total
        results.append([gen, engine.run_all([verify], max_new_tokens=MAX_NEW)[0]])
        if engine._radix is not None:
            full = (len(engine.tokenizer.encode(generate, add_bos=True)) // 16) * 16
            assert results[-1][1].prefix_hit_tokens >= full
            assert engine.prefix_hit_tokens_total - before == results[-1][1].prefix_hit_tokens
    assert_same(*results, ref, port)


@pytest.mark.parametrize("config", CONFIGS, ids=CONFIG_IDS)
def test_small_pool_evicts_and_skips_ahead(weights, config):
    """A pool of 13 usable pages for 4 slots of up to 8: a long prompt that
    does not fit is jumped by a small one behind it, and with the cache on
    unpinned cached prefixes are evicted to make room. The same decisions
    on both sides, step by step."""
    ref, port = make_engines(weights, config, num_pages=14)
    waves = (["alpha beta gamma " * 8, "short"], ["delta epsilon zeta " * 8, "tiny"],
             ["x", HEAD + "one"], [HEAD + "two", "eta theta iota " * 8])
    results, skips = [], []
    for engine in (ref, port):
        ids, done, seen = [], {}, []
        for wave in waves:
            ids += [engine.submit(p, 16, 0.0) for p in wave]
            for r in engine.step():
                done[r.request_id] = r
            seen.append(engine._head_skips)
        while engine.has_work:
            for r in engine.step():
                done[r.request_id] = r
            seen.append(engine._head_skips)
        results.append([done[i] for i in ids])
        skips.append(seen)
    assert_same(*results, ref, port)
    assert skips[0] == skips[1] and max(skips[1]) >= 1
    if port._radix is not None:
        assert port._radix.evicted_pages == ref._radix.evicted_pages > 0
        assert port._radix.stats() == ref._radix.stats()


def test_warm_prefix_and_peek_prefix(engines):
    """warm_prefix caches a text's full pages (0 with the cache off) and
    peek_prefix reports what a prompt could reuse, clamped as admission
    clamps it; the first request with that head then admits suffix-only.
    The same numbers and tokens on both sides."""
    ref, port = engines
    # inside the 102 tokens a prompt keeps of the 128-token window
    text = "[2] Source: warm.md\nA warmed head is served from the tree. "
    prompt = text + "Q: does the first request hit it?"
    ids = port.tokenizer.encode(prompt, add_bos=True)
    got = [(e.warm_prefix(text), e.peek_prefix(ids), e.warm_prefix(text)) for e in engines]
    assert got[0] == got[1]
    warmed, peek, again = got[1]
    assert again == warmed
    assert (warmed > 0) == (port._radix is not None) and peek == warmed
    results = [e.run_all([prompt], max_new_tokens=MAX_NEW) for e in engines]
    assert_same(*results, ref, port)
    assert results[1][0].prefix_hit_tokens == peek


def test_pages_reclaimed_after_drain(engines):
    """After a drain every page is free or held by the radix cache, and no
    node stays pinned."""
    _ref, port = engines
    port.run_all(["reclaim one", "reclaim two " * 5], max_new_tokens=6)
    held = port._radix.pages_held if port._radix is not None else 0
    assert port.allocator.free_pages + held == port.allocator.num_pages - 1
    assert not any(s.active for s in port.slots)
    if port._radix is not None:
        stack = list(port._radix.root.children.values())
        while stack:
            node = stack.pop()
            assert node.refcount == 0
            stack.extend(node.children.values())


def test_kernel_and_plain_paths_agree(engines):
    """attn_impl=_paged_attn_xla swaps in the plain gather path; on the CPU
    the kernel wrapper takes the plain version too: the same tokens."""
    _ref, port = engines
    plain = ContinuousBatchingEngine(model_config=port.cfg, params=port.params,
                                     device="cpu", **ENGINE_KW)
    plain.attn_impl = _paged_attn_xla
    prompts = PROMPT_SETS["mixed_lengths"]
    assert ([r.tokens for r in plain.run_all(prompts, max_new_tokens=8)]
            == [r.tokens for r in port.run_all(prompts, max_new_tokens=8)])


def test_chunked_prefill_matches_whole_prompt(weights):
    """The port alone: prefill_chunk=32 gives the same greedy tokens as
    whole-prompt admission, and prefills the same number of tokens."""
    _ref, whole = make_engines(weights, (True, 1, None))
    _ref, chunked = make_engines(weights, (True, 1, 32))
    prompts = [HEAD * 2 + "long enough to take several segments", "short"]
    a = whole.run_all(prompts, max_new_tokens=MAX_NEW)
    b = chunked.run_all(prompts, max_new_tokens=MAX_NEW)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert whole.prefill_tokens_total == chunked.prefill_tokens_total


@pytest.mark.parametrize("config", CONFIGS[:2], ids=CONFIG_IDS[:2])
def test_prefill_split_by_score_bytes(weights, config):
    """A score budget below one row's scores splits every admission group
    into one-row dispatches (cold and prefix-hit rows alike): the same
    greedy tokens and prefix hits as unsplit admission."""
    _ref, whole = make_engines(weights, config)
    _ref, split = make_engines(weights, config)
    split.PREFILL_SCORE_BYTES = 1
    waves = ([HEAD + "one", HEAD + "two", "cold"], [HEAD + "three", HEAD + "four", "x"])
    a, b = run_staggered(whole, waves), run_staggered(split, waves)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert [r.prefix_hit_tokens for r in a] == [r.prefix_hit_tokens for r in b]
    assert (whole._radix is None) or sum(r.prefix_hit_tokens for r in b) > 0


def test_sub_steps_count_what_ran(engines):
    """total_sub_steps counts the sub-steps the ticks ran: the longest
    budget of each tick, so a lone request of n tokens runs n - 1."""
    _ref, port = engines
    before = port.total_sub_steps
    (result,) = port.run_all(["count my sub-steps"], max_new_tokens=9)
    assert result.finish_reason == "length" and len(result.tokens) == 9
    assert port.total_sub_steps - before == 8


def test_stats_report_prefix_and_graph_counters(engines):
    _ref, port = engines
    stats = port.stats()
    assert stats["prefill_tokens"] == port.prefill_tokens_total
    assert stats["graph_captures"] == stats["graph_replays"] == 0  # none on the CPU
    assert ("prefix_hit_tokens" in stats) == (port._radix is not None)


def test_greedy_sampling_and_logprob_match():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((6, 40)).astype(np.float32) * 3
    top_k = np.asarray([0, 1, 3, 0, -1, 40], np.int32)
    tok, lp = sample_tokens(torch.from_numpy(logits), None, np.zeros(6, np.float32), top_k)
    jtok, jlp = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                           jnp.zeros(6), top_k=jnp.asarray(top_k))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6, rtol=0)


@pytest.mark.parametrize("temps,top_k", [([0.0] * 6, [0] * 6),
                                         ([0.0, 0.7, 1.3, 0.0, 2.0, 0.5], [0] * 6),
                                         ([0.0, 0.7, 1.3, 0.0, 2.0, 0.5], [0, 3, 0, 1, 5, 0])])
def test_sampling_with_device_tensors_and_host_flags(temps, top_k):
    """Tensors plus the all-greedy / any-top-k flags (what the captured
    sub-step passes) give the tokens and logprobs of the host-value call,
    from the same generator state."""
    logits = torch.from_numpy(
        np.random.default_rng(14).standard_normal((6, 50)).astype(np.float32) * 2)
    temps_np, top_k_np = np.asarray(temps, np.float32), np.asarray(top_k, np.int64)
    want = sample_tokens(logits, torch.Generator().manual_seed(3), temps_np, top_k_np)
    got = sample_tokens(logits, torch.Generator().manual_seed(3), torch.from_numpy(temps_np),
                        torch.from_numpy(top_k_np), all_greedy=bool((temps_np <= 0).all()),
                        any_top_k=bool((top_k_np > 0).any()))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.7, 0, 1.0), (1.3, 4, 1.0),
                                                     (1.0, 0, 0.8)])
def test_temperature_sampling_matches_in_distribution(temperature, top_k, top_p):
    """Histograms of 20k draws from one logits row: total-variation distance
    between the two samplers below 0.03 (sampling noise at 20k draws over
    12 tokens is ~0.01), and identical support after top-k / top-p."""
    n, v = 20_000, 12
    row = np.random.default_rng(13).standard_normal(v).astype(np.float32) * 2
    logits = np.repeat(row[None, :], n, axis=0)
    gen = torch.Generator().manual_seed(5)
    tok, lp = sample_tokens(torch.from_numpy(logits), gen, np.full(n, temperature, np.float32),
                            np.full(n, top_k, np.int64), top_p=top_p)
    jtok, jlp = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(5),
                           jnp.full((n,), temperature), top_k=jnp.full((n,), top_k),
                           top_p=top_p)
    h_port = np.bincount(tok.numpy(), minlength=v) / n
    h_ref = np.bincount(np.asarray(jtok), minlength=v) / n
    assert 0.5 * np.abs(h_port - h_ref).sum() < 0.03
    assert set(np.flatnonzero(h_port)) == set(np.flatnonzero(h_ref))
    # the logprob is the unscaled model distribution's, whatever was drawn
    full = torch.log_softmax(torch.from_numpy(row), -1).numpy()
    np.testing.assert_allclose(lp.numpy(), full[tok.numpy()], atol=1e-6, rtol=0)
