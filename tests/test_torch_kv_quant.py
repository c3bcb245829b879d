"""The port's int8 KV pool (``kv_quant="int8"``) against the JAX package.

* ``quantize_kv`` / ``dequantize_kv`` on identical float32 inputs: int8
  codes and f16 scales bit-identical, zero vectors and values exactly on a
  .5 code boundary included (both round half to even).
* The engine with an int8 pool against the JAX engine (Pallas int8 kernel
  in interpret mode) on shared float32 tiny-Llama weights: one decode step
  over a carried pool, and greedy drains in the four engine configurations
  (prefix cache off and on, pipeline depth 1 and 2, chunked prefill).
* The engine's own behaviour: pool bytes, the ``kv_quant`` check, and
  decode routed through ``paged_attention_quant``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.kernels.paged_attention import make_paged_attn_impl
from sentio_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JaxEngine
from sentio_tpu.runtime.paged import dequantize_kv as jax_dequantize
from sentio_tpu.runtime.paged import paged_decode_forward as jax_decode_forward
from sentio_tpu.runtime.paged import quantize_kv as jax_quantize
from sentio_tpu_torch import kernels
from sentio_tpu_torch.kernels import paged_attn_impl
from sentio_tpu_torch.kernels.paged_attention import QuantPages
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.runtime.paged import (
    ContinuousBatchingEngine,
    dequantize_kv,
    init_pool,
    paged_decode_forward,
    quantize_kv,
)
from sentio_tpu_torch.runtime.weights import llama_from_jax
from _sanitize import _sanitized  # noqa: F401  (arms the module)


MAX_NEW = 24
ENGINE_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=8)


def _quant_inputs(name):
    rng = np.random.default_rng(7)
    if name == "random_scales":
        x = rng.standard_normal((6, 16, 2, 128)) * rng.uniform(1e-3, 40, (6, 16, 2, 1))
    elif name == "zero_vectors":
        x = rng.standard_normal((4, 5, 32))
        x[0] = 0.0
        x[2, 3] = 0.0
    else:  # half_boundaries: absmax 127·2^e makes x / scale exact, k + 0.5
        row = np.asarray([127, 0.5, 1.5, 2.5, -3.5, -0.5, 126.5, -126.5] * 4)
        x = np.stack([row * 2.0 ** e for e in range(-8, 4)])
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ["random_scales", "zero_vectors", "half_boundaries"])
def test_quantize_kv_bit_identical(name):
    """Codes and scales bit-identical to the JAX functions; dequantized
    values equal (the same float32 products, rounded once)."""
    x = _quant_inputs(name)
    jq, js = (np.asarray(a) for a in jax_quantize(jnp.asarray(x)))
    q, s = quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float16
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy().view(np.uint16), js.view(np.uint16))
    back = dequantize_kv(q, s, torch.float32).numpy()
    np.testing.assert_array_equal(back, np.asarray(jax_dequantize(jq, js, jnp.float32)))
    zero = ~x.any(axis=-1)
    assert not s.numpy()[zero].any() and not back[zero].any()
    if name == "half_boundaries":  # half to even: 0.5 → 0, 1.5 → 2, 2.5 → 2, -3.5 → -4
        np.testing.assert_array_equal(q.numpy()[:, :8], [[127, 0, 2, 2, -4, 0, 126, -126]] * 12)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(JaxLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(11), jcfg))
    return jcfg, tree


# (prefix_cache, pipeline_depth, prefill_chunk), as in test_torch_paged.py
CONFIGS = [(False, 1, None), (True, 1, None), (True, 2, None), (True, 2, 32)]
CONFIG_IDS = ["plain", "prefix", "prefix_depth2", "prefix_depth2_chunk32"]


def _engines(weights, config=(False, 1, None)):
    jcfg, tree = weights
    prefix_cache, depth, chunk = config
    kw = dict(ENGINE_KW, kv_quant="int8", prefix_cache=prefix_cache, pipeline_depth=depth,
              prefill_chunk=chunk)
    ref = JaxEngine(model_config=jcfg, params=tree, use_pallas=True, **kw)
    port = ContinuousBatchingEngine(model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                                    params=llama_from_jax(tree), device="cpu", **kw)
    return ref, port


def test_one_decode_step_over_a_carried_pool(weights):
    """The JAX engine's int8 pool (random K/V quantized by the JAX
    ``quantize_kv``) is copied into the port's pool; one decode step on both
    with the same tokens, lens and table. Logits agree to 1e-4 (float32
    forwards in another summation order). The step's K/V agree to ~1e-6
    before quantization, so a code may differ by exactly 1 where the float
    input straddles a rounding boundary, and a scale by one f16 ulp; the
    rest of the pool is untouched on both sides."""
    ref, port = _engines(weights)
    cfg = port.cfg
    rng = np.random.default_rng(3)
    shape = (cfg.n_layers, 33, 16, cfg.n_kv_heads, cfg.head_dim)
    pools = []
    for _ in range(2):
        kq, ks = jax_quantize(jnp.asarray(rng.standard_normal(shape), jnp.float32))
        pools.append({"q": kq, "s": ks})
    ref.pool.k, ref.pool.v = pools
    port.pool.k, port.pool.v = (
        QuantPages(torch.from_numpy(np.array(p["q"])), torch.from_numpy(np.array(p["s"])))
        for p in pools)

    table = np.zeros((4, 8), np.int32)
    table[1:] = rng.permutation(np.arange(1, 33))[:24].reshape(3, 8)
    lens = np.asarray([0, 5, 16, 77], np.int32)  # a free slot, first page, page edge, mid
    tok = np.asarray([0, 65, 300, 17], np.int32)
    jlogits, jk, jv = jax_decode_forward(
        ref.params, ref.cfg, jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(table),
        ref.pool.k, ref.pool.v, attn_impl=make_paged_attn_impl(interpret=True))
    with torch.inference_mode():
        logits = paged_decode_forward(
            port.params, cfg, torch.from_numpy(tok).long(), torch.from_numpy(lens),
            torch.from_numpy(table), port.pool.k, port.pool.v, attn_impl=paged_attn_impl)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)

    flips = 0
    for got, want, before in ((port.pool.k, jk, pools[0]), (port.pool.v, jv, pools[1])):
        dq = got.q.numpy().astype(np.int32) - np.asarray(want["q"]).astype(np.int32)
        assert np.abs(dq).max() <= 1
        flips += int((dq != 0).sum())
        np.testing.assert_allclose(got.s.numpy().astype(np.float32),
                                   np.asarray(want["s"]).astype(np.float32),
                                   rtol=2.0 ** -10, atol=0)
        written = np.asarray(before["q"]) != np.asarray(want["q"])
        assert written.any()
        assert not dq[~written.any(axis=-1, keepdims=True).repeat(dq.shape[-1], -1)].any()
    print(f"int8 codes differing by one step of rounding: {flips} of "
          f"{2 * cfg.n_layers * 4 * cfg.n_kv_heads * cfg.head_dim}")


HEAD = "You answer from the numbered sources below and cite them. " * 2
PROMPT_SETS = {
    "single": ["paged equivalence check"],
    "mixed_lengths": ["a", "a much longer prompt that spans several pages of cache " * 2,
                      "mid size prompt"],
    "more_than_slots": [f"request number {i} " * (i % 3 + 1) for i in range(7)],
    "shared_heads": [HEAD + q for q in ("what is a page?", "who owns a slot?",
                                        "why a radix tree?", "where is scratch?",
                                        "how do ticks pipeline?")],
}


def _assert_same(want, got, ref, port):
    for r, p in zip(want, got, strict=True):
        assert p.tokens == r.tokens
        assert p.finish_reason == r.finish_reason
        assert p.prompt_tokens == r.prompt_tokens
        assert (p.prefill_tokens, p.prefix_hit_tokens) == (r.prefill_tokens,
                                                           r.prefix_hit_tokens)
        assert p.logprob_count == r.logprob_count
        np.testing.assert_allclose([p.logprob_sum, p.logprob_min],
                                   [r.logprob_sum, r.logprob_min], atol=1e-4, rtol=0)
    assert port.prefill_tokens_total == ref.prefill_tokens_total
    assert port.prefix_hit_tokens_total == ref.prefix_hit_tokens_total


@pytest.fixture(scope="module", params=CONFIGS, ids=CONFIG_IDS)
def int8_engines(request, weights):
    return _engines(weights, request.param)


@pytest.mark.parametrize("name", sorted(PROMPT_SETS))
def test_greedy_drain_matches_jax_int8_engine(int8_engines, name):
    """Greedy output token-exact against the JAX int8 engine in each engine
    configuration, logprob accumulators within 1e-4, the same prefix-hit
    and prefill token counts. The two pools are quantized from float32 K/V
    that agree to ~1e-6, so a 1-code flip could in principle move a greedy
    token; these prompts show none. A prefix hit attends to the matched
    pages dequantized, on both sides."""
    ref, port = int8_engines
    prompts = PROMPT_SETS[name]
    want = ref.run_all(prompts, max_new_tokens=MAX_NEW, temperature=0.0)
    got = port.run_all(prompts, max_new_tokens=MAX_NEW, temperature=0.0)
    _assert_same(want, got, ref, port)


def test_staggered_shared_heads_match_jax_int8_engine(int8_engines):
    """Requests with a shared head join while others decode, and a verify
    style prompt embeds an earlier prompt: the later admissions hit the
    int8 pages the earlier ones wrote."""
    ref, port = int8_engines
    first = "[1] Source: notes.md\nPages hold sixteen tokens each.\nQ: what is a page?"
    # the empty wave gives a chunked first prompt the tick its last
    # segment needs before it is in the tree
    waves = ([first], [HEAD + "second"], [], [first + "\nAnswer: pages.\nAudit it.", "x"])
    results = []
    for engine in (ref, port):
        ids, done = [], {}
        for wave in waves:
            ids += [engine.submit(p, MAX_NEW, 0.0) for p in wave]
            for r in engine.step():
                done[r.request_id] = r
        while engine.has_work:
            for r in engine.step():
                done[r.request_id] = r
        results.append([done[i] for i in ids])
    _assert_same(*results, ref, port)
    if port._radix is not None:
        assert results[1][2].prefix_hit_tokens >= 64


def test_int8_pool_bytes():
    """L·P·page·Hkv·(D + 2)·2: int8 codes plus f16 scales, for K and V."""
    cfg = LlamaConfig.tiny()
    pool = init_pool(cfg, num_pages=33, page_size=16, device="cpu", quantized=True)
    n_l, p, page, hkv, d = cfg.n_layers, 33, 16, cfg.n_kv_heads, cfg.head_dim
    assert pool.quantized
    assert pool.hbm_bytes == n_l * p * page * hkv * (d + 2) * 2
    bf16 = init_pool(cfg, num_pages=33, page_size=16, device="cpu")
    assert not bf16.quantized and bf16.hbm_bytes == n_l * p * page * hkv * d * 2 * 2
    engine = ContinuousBatchingEngine(model_config=cfg, device="cpu", kv_quant="int8",
                                      **ENGINE_KW)
    assert engine.pool.hbm_bytes == n_l * 33 * page * hkv * (d + 2) * 2


@pytest.mark.parametrize("kv_quant", ["fp4", "int4", "INT8", ""])
def test_unknown_kv_quant_raises(kv_quant):
    with pytest.raises(ValueError, match="kv_quant"):
        ContinuousBatchingEngine(model_config=LlamaConfig.tiny(), device="cpu",
                                 kv_quant=kv_quant)


def test_decode_routes_through_the_int8_wrapper(monkeypatch):
    """With an int8 pool every decode sub-step calls paged_attention_quant
    once per layer, on views of the pool, and never the bf16 wrapper."""
    calls = {"quant": 0, "bf16": 0}
    quant, bf16 = kernels.paged_attention_quant, kernels.paged_attention

    def spy_quant(q, k_q, k_s, v_q, v_s, table, lens):
        calls["quant"] += 1
        assert k_q.dtype == torch.int8 and k_s.dtype == torch.float16 and k_q.is_contiguous()
        return quant(q, k_q, k_s, v_q, v_s, table, lens)

    def spy_bf16(*args):
        calls["bf16"] += 1
        return bf16(*args)

    monkeypatch.setattr(kernels, "paged_attention_quant", spy_quant)
    monkeypatch.setattr(kernels, "paged_attention", spy_bf16)
    cfg = LlamaConfig.tiny()
    engine = ContinuousBatchingEngine(model_config=cfg, device="cpu", kv_quant="int8",
                                      **ENGINE_KW)
    engine.run_all(["route me", "and me too"], max_new_tokens=6)
    assert engine.total_sub_steps > 0
    assert calls == {"quant": cfg.n_layers * engine.total_sub_steps, "bf16": 0}
