"""The port's contiguous engine (``runtime/engine.py::GeneratorEngine``)
against the JAX ``GeneratorEngine`` on shared float32 tiny-Llama weights
(made by the JAX init, carried by sentio_tpu_torch.runtime.weights).

Greedy generation is token-exact, with the same finish reasons and prompt
lengths; the bucket choices and ``_stable_steps`` are equal; ``stream``
yields ``generate``'s text. The causal adapter's plain path (what the card
runs as ``flash_attention.cu``) is held to JAX's ``flash_attn_fn`` in
interpret mode at the engine's shape, keys over the whole cache window
(S > T), atol 2e-5 in float32 as tests/test_torch_kernels.py holds the
plain versions."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.kernels import flash_attn_fn as jax_flash_attn_fn
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.engine import GeneratorEngine as JEngine
from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.kernels import default_attn_fn, flash_attn_fn
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.weights import llama_from_jax

GEN = dict(model_preset="tiny", max_new_tokens=20, max_prompt_tokens=4096, dtype="float32")
PROMPTS = ["a", "a much longer prompt that spans several buckets of cache " * 3,
           "mid size prompt"]


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(5), jcfg))
    ref = JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, params=tree)
    port = GeneratorEngine(config=GeneratorConfig(**GEN),
                           model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                           params=llama_from_jax(tree), device="cpu")
    return ref, port


@pytest.mark.parametrize("max_new", [1, 7, 20, 64])
def test_generate_greedy_matches_jax(engines, max_new):
    """3 ragged prompts in one batch (a junk bucket row pads it to 4)."""
    ref, port = engines
    want = ref.generate(PROMPTS, max_new_tokens=max_new, temperature=0.0)
    got = port.generate(PROMPTS, max_new_tokens=max_new, temperature=0.0)
    for r, p in zip(want, got):
        assert p.tokens == r.tokens
        assert p.text == r.text
        assert p.finish_reason == r.finish_reason
        assert p.prompt_tokens == r.prompt_tokens
    assert any(p.tokens for p in got)


def test_generate_chunks_past_the_largest_batch_bucket(engines):
    ref, port = engines
    prompts = [f"row {i} " * (i % 4 + 1) for i in range(18)]
    want = ref.generate(prompts, max_new_tokens=6, temperature=0.0)
    got = port.generate(prompts, max_new_tokens=6, temperature=0.0)
    assert [p.tokens for p in got] == [r.tokens for r in want]
    assert [p.finish_reason for p in got] == [r.finish_reason for r in want]


@pytest.mark.parametrize("requested,headroom", [(1, 100), (3, 100), (20, 100), (48, 100),
                                                (100, 40), (64, 64), (5000, 9000), (7, 8),
                                                (4096, 4096)])
def test_stable_steps_match_jax(engines, requested, headroom):
    ref, port = engines
    assert port._stable_steps(requested, headroom) == ref._stable_steps(requested, headroom)


@pytest.mark.parametrize("max_new", [1, 20, 400])
def test_encode_batch_buckets_match_jax(engines, max_new):
    """Padded ids, lengths, pad mask and the cache window (bucket of width
    + max_new, capped at max_len)."""
    ref, port = engines
    j_ids, j_pos, j_lens, j_cache, j_n, j_window, j_mask = ref._encode_batch(PROMPTS, max_new)
    ids, pos, lens, cache, n, window, mask = port._encode_batch(PROMPTS, max_new)
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_array_equal(pos, np.asarray(j_pos))
    np.testing.assert_array_equal(lens, np.asarray(j_lens))
    np.testing.assert_array_equal(mask, np.asarray(j_mask))
    assert (n, window) == (j_n, j_window)
    assert tuple(cache["k"].shape) == tuple(j_cache["k"].shape)


def test_stream_yields_generate_text(engines):
    ref, port = engines
    for prompt in PROMPTS:
        text = port.generate([prompt], max_new_tokens=20, temperature=0.0)[0].text
        pieces = list(port.stream(prompt, max_new_tokens=20, temperature=0.0))
        assert "".join(pieces) == text
        assert "".join(ref.stream(prompt, max_new_tokens=20, temperature=0.0)) == text


def test_sampled_generation_uses_the_engine_generator(engines):
    """Sampling draws from the engine's own generator: reseeding it repeats
    the draw (threefry and Philox differ, so JAX is not the oracle here)."""
    _ref, port = engines
    port._gen.manual_seed(3)
    a = port.generate(PROMPTS, max_new_tokens=12, temperature=1.0)
    port._gen.manual_seed(3)
    b = port.generate(PROMPTS, max_new_tokens=12, temperature=1.0)
    assert [x.tokens for x in a] == [x.tokens for x in b]


def test_device_stats_and_refusals(engines):
    _ref, port = engines
    stats = port.device_stats()
    assert stats["platform"] == "cpu" and stats["model"]["layers"] == 2
    with pytest.raises(NotImplementedError):
        GeneratorEngine(config=GeneratorConfig(**GEN), mesh=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        GeneratorEngine(config=GeneratorConfig(**GEN), forward_fn=lambda *a: a, device="cpu")


def test_default_attn_fn_picks_flash_for_the_card_only():
    assert default_attn_fn("cuda") is flash_attn_fn
    assert default_attn_fn("cpu") is None


@pytest.mark.parametrize("b,t,s,h,d", [(1, 64, 128, 2, 16), (3, 32, 96, 4, 32),
                                       (2, 50, 64, 2, 16)])
def test_causal_adapter_plain_matches_jax_flash_at_s_over_t(b, t, s, h, d):
    """The engine's prefill shape: T new queries at positions 0..T-1, keys
    over the whole cache window (kv_lens None, S > T), the window's tail
    unwritten (random here: no query may attend it)."""
    rng = np.random.default_rng(t + s)
    q = rng.standard_normal((b, t, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, h, d)).astype(np.float32)
    v = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ref = np.asarray(jax_flash_attn_fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = flash_attn_fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
    # the tail never matters
    k[:, t:] = np.nan
    v[:, t:] = np.nan
    tail = flash_attn_fn(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v))
    np.testing.assert_allclose(tail.numpy(), ref, atol=2e-5, rtol=0)


def test_prefill_through_the_adapter_matches_plain_attention(engines):
    """llama_forward over the contiguous cache with the causal adapter (its
    plain path on the CPU) gives the plain masked attention's logits."""
    _ref, port = engines
    ids, pos, lens, cache, _n, _window, mask = port._encode_batch(PROMPTS, 20)
    plain = port._prefill(ids, pos, cache, mask)
    port.attn_fn = flash_attn_fn
    try:
        _ids, _pos, _lens, cache2, _n, _w, _m = port._encode_batch(PROMPTS, 20)
        flash = port._prefill(ids, pos, cache2, mask)
    finally:
        port.attn_fn = default_attn_fn("cpu")
    for row, n in enumerate(lens[:3]):
        np.testing.assert_allclose(flash[row, :n].numpy(), plain[row, :n].numpy(),
                                   atol=1e-4, rtol=0)
