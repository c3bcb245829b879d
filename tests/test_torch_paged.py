"""The port's paged continuous-batching engine against the JAX engine.

Both engines share one set of float32 tiny-Llama weights (made by the JAX
init, carried by sentio_tpu_torch.runtime.weights). The JAX engine runs its
Pallas paged kernel in interpret mode (use_pallas=True — off the TPU it
would otherwise take its XLA gather path) with the radix prefix cache off,
the admission path this port implements. Greedy output must be
token-exact; the logprob accumulators agree within 1e-4 (float32
log-softmax of logits that agree to ~1e-6). Temperature sampling draws
from different generators (threefry vs Philox), so it is compared by
distribution."""

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

MAX_NEW = 24
ENGINE_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=8)


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(11), jcfg))
    ref = JaxEngine(model_config=jcfg, params=tree, use_pallas=True,
                    prefix_cache=False, **ENGINE_KW)
    port = ContinuousBatchingEngine(
        model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
        params=llama_from_jax(tree), device="cpu", **ENGINE_KW)
    return ref, port


def _drain(engine):
    done = {}
    while engine.has_work:
        for r in engine.step():
            done[r.request_id] = r
    return done


def _assert_same(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for r, p in zip(ref_results, port_results):
        assert p.tokens == r.tokens
        assert p.text == r.text
        assert p.finish_reason == r.finish_reason
        assert p.prompt_tokens == r.prompt_tokens
        assert p.logprob_count == r.logprob_count
        np.testing.assert_allclose([p.logprob_sum, p.logprob_min],
                                   [r.logprob_sum, r.logprob_min], atol=1e-4, rtol=0)


PROMPT_SETS = {
    "single": ["paged equivalence check"],
    "mixed_lengths": ["a", "a much longer prompt that spans several pages of cache " * 2,
                      "mid size prompt"],
    # more requests than the 4 slots: the rest admit as slots retire
    "more_than_slots": [f"request number {i} " * (i % 3 + 1) for i in range(7)],
}


@pytest.mark.parametrize("name", sorted(PROMPT_SETS))
def test_greedy_token_exact(engines, name):
    ref, port = engines
    prompts = PROMPT_SETS[name]
    _assert_same(ref.run_all(prompts, max_new_tokens=MAX_NEW, temperature=0.0),
                 port.run_all(prompts, max_new_tokens=MAX_NEW, temperature=0.0))


def test_staggered_arrivals_token_exact(engines):
    """Requests join while others decode: same admission ticks on both."""
    results = []
    for engine in engines:
        ids, done = [], {}
        for wave in (["first arrival"], ["second, a bit later", "third"], ["last one in"]):
            ids += [engine.submit(p, MAX_NEW, 0.0) for p in wave]
            for r in engine.step():
                done[r.request_id] = r
        done.update(_drain(engine))
        results.append([done[i] for i in ids])
    _assert_same(*results)


def test_pages_reclaimed_after_drain(engines):
    _ref, port = engines
    before = port.allocator.free_pages
    port.run_all(["reclaim one", "reclaim two " * 5], max_new_tokens=6)
    assert port.allocator.free_pages == before == port.allocator.num_pages - 1
    assert not any(s.active for s in port.slots)


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


def test_greedy_sampling_and_logprob_match():
    rng = np.random.default_rng(12)
    logits = rng.standard_normal((6, 40)).astype(np.float32) * 3
    top_k = np.asarray([0, 1, 3, 0, -1, 40], np.int32)
    tok, lp = sample_tokens(torch.from_numpy(logits), None, np.zeros(6, np.float32), top_k)
    jtok, jlp = jax_sample(jnp.asarray(logits), jax.random.PRNGKey(0),
                           jnp.zeros(6), top_k=jnp.asarray(top_k))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-6, rtol=0)


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
