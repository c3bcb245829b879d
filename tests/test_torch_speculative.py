"""The port's speculative decoding on the contiguous engine
(``runtime/speculative.py``) against the JAX package's, case for case with
``tests/test_speculative.py``.

Target and drafts are float32 tiny Llamas made by the JAX init functions
and carried across with ``runtime/weights.py``. Greedy speculation is
token-exact against JAX's ``SpeculativeDecoder`` and against the port's own
plain engine, with the same finish reasons, and its ``stats`` (rounds,
tokens) equal JAX's exactly. The sampled rule draws from torch's generator
(JAX draws from threefry), so ``accept_and_correct`` is held by
distribution: over 40,000 draws on a 6-token vocabulary the first emitted
token's frequencies lie within 0.015 of the target's probabilities (JAX's
own bound) and within 0.02 of them in total variation."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.runtime.engine import GeneratorEngine as JEngine
from sentio_tpu.runtime.speculative import SpeculativeDecoder as JDecoder
from sentio_tpu.runtime.speculative import SpeculativeError as JSpeculativeError
from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.ops.generator import EngineProvider
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.speculative import (
    SpeculativeDecoder,
    SpeculativeError,
    accept_and_correct,
)
from sentio_tpu_torch.runtime.weights import llama_from_jax

GEN = dict(model_preset="tiny", max_new_tokens=16, dtype="float32")
FREQ_ATOL, TV_LIMIT = 0.015, 0.02


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


# name → (draft config, init key); "perfect" is the target itself
DRAFTS = {
    "weak": (_f32(JLlamaConfig.tiny()), 999),
    "small": (_f32(JLlamaConfig(vocab_size=512, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                                mlp_dim=64, max_len=512, rope_theta=10_000.0)), 7),
}
# (draft, k, prompts, max_new) as tests/test_speculative.py runs them
CASES = {
    "perfect": ("perfect", 4, ["speculate on this", "another prompt"], 12),
    "weak": ("weak", 3, ["a different draft model", "with other weights", "third"], 14),
    "small": ("small", 4, ["tiny draft, tiny target"], 10),
    # a budget that ends mid-round: 7 tokens from rounds of up to 5
    "perfect_mid_round": ("perfect", 4, ["speculate on this", "the budget ends"], 7),
}


@pytest.fixture(scope="module")
def stack():
    jcfg = _f32(JLlamaConfig.tiny())
    tree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(0), jcfg))
    ref = JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, params=tree)
    port = GeneratorEngine(config=GeneratorConfig(**GEN),
                           model_config=LlamaConfig(**dataclasses.asdict(jcfg)),
                           params=llama_from_jax(tree), device="cpu")
    drafts = {}
    for name, (dcfg, key) in DRAFTS.items():
        dtree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(key), dcfg))
        drafts[name] = ((dtree, dcfg),
                        (llama_from_jax(dtree), LlamaConfig(**dataclasses.asdict(dcfg))))
    return ref, port, drafts


def decoders(stack, draft: str, k: int):
    """JAX's decoder and the port's over the same draft; "perfect" hands
    each engine its own target tensors."""
    ref, port, drafts = stack
    if draft == "perfect":
        return (JDecoder(ref, ref.params, ref.model_config, k=k),
                SpeculativeDecoder(port, port.params, port.model_config, k=k))
    (jtree, jcfg), (params, cfg) = drafts[draft]
    return JDecoder(ref, jtree, jcfg, k=k), SpeculativeDecoder(port, params, cfg, k=k)


def same(results):
    return [(r.tokens, r.finish_reason, r.prompt_tokens) for r in results]


@pytest.mark.parametrize("case", sorted(CASES))
def test_greedy_matches_jax_and_the_plain_engine(stack, case):
    """The port's greedy speculative tokens equal JAX's and the port's plain
    engine's, and the decoders' stats are equal; the perfect draft accepts
    nearly everything."""
    draft, k, prompts, max_new = CASES[case]
    jspec, spec = decoders(stack, draft, k)
    want = jspec.generate(prompts, max_new_tokens=max_new)
    got = spec.generate(prompts, max_new_tokens=max_new)
    plain = stack[1].generate(prompts, max_new_tokens=max_new, temperature=0.0)
    assert same(got) == same(want) == same(plain)
    assert spec.stats == jspec.stats and spec.stats["rounds"] > 0
    assert spec.prefills == 2
    if case == "perfect":
        assert spec.tokens_per_round > 3.0
    if case == "weak":
        assert 1.0 <= spec.tokens_per_round <= 4.0


def test_finish_reasons_match_plain_engine(stack):
    jspec, spec = decoders(stack, "perfect", 2)
    prompts = ["finish reason check"]
    want = jspec.generate(prompts, max_new_tokens=8)
    got = spec.generate(prompts, max_new_tokens=8)
    plain = stack[1].generate(prompts, max_new_tokens=8, temperature=0.0)
    assert same(got) == same(want) == same(plain)


def test_near_window_prompt_goes_to_the_engine(stack):
    """A prompt so close to the end of its window that the verify block's
    spill would shorten its budget is handed to ``engine.generate``, as in
    JAX: the plain tokens, and no round is counted."""
    jspec, spec = decoders(stack, "weak", 4)
    prompts = ["w" * 503]
    want = jspec.generate(prompts, max_new_tokens=16)
    got = spec.generate(prompts, max_new_tokens=16)
    plain = stack[1].generate(prompts, max_new_tokens=16, temperature=0.0)
    assert same(got) == same(want) == same(plain)
    assert spec.stats == jspec.stats == {"rounds": 0, "tokens": 0}
    assert spec.prefills == 0


@pytest.mark.parametrize("k", [1, 3])
def test_acceptance_preserves_the_target_distribution(k):
    """The first emitted token's marginal (the draft if accepted, else the
    correction) equals the target's distribution for a very different
    draft distribution, over 40,000 independent rounds."""
    v, n = 6, 40_000
    rng = np.random.default_rng(0)
    p_t = rng.dirichlet(np.ones(v))
    q = rng.dirichlet(np.ones(v) * 0.3)
    gen = torch.Generator().manual_seed(1)
    tprobs = torch.tensor(np.broadcast_to(p_t, (n, k + 1, v)).copy(), dtype=torch.float32)
    qdists = torch.tensor(np.broadcast_to(q, (n, k, v)).copy(), dtype=torch.float32)
    drafts = torch.multinomial(qdists.reshape(-1, v), 1, generator=gen).reshape(n, k)
    n_accept, correction = accept_and_correct(gen, drafts, qdists, tprobs)
    assert n_accept.min() >= 0 and n_accept.max() <= k
    first = torch.where(n_accept > 0, drafts[:, 0], correction).numpy()
    freq = np.bincount(first, minlength=v) / n
    np.testing.assert_allclose(freq, p_t, atol=FREQ_ATOL)
    assert 0.5 * np.abs(freq - p_t).sum() <= TV_LIMIT


def test_zero_residual_falls_back_to_the_target():
    """Target and draft equal with no mass on the drafted token: the draft
    is rejected, the residual is zero, and the correction comes from the
    target's own distribution."""
    n, v = 20_000, 5
    p = torch.tensor([0.0, 0.1, 0.2, 0.3, 0.4])
    tprobs = p.expand(n, 2, v).clone()
    qdists = p.expand(n, 1, v).clone()
    drafts = torch.zeros((n, 1), dtype=torch.int64)
    n_accept, correction = accept_and_correct(torch.Generator().manual_seed(2), drafts,
                                              qdists, tprobs)
    assert int(n_accept.max()) == 0
    freq = np.bincount(correction.numpy(), minlength=v) / n
    np.testing.assert_allclose(freq, p.numpy(), atol=FREQ_ATOL)


def test_sampled_generate_runs_and_is_seed_deterministic(stack):
    _, spec = decoders(stack, "weak", 3)
    port = stack[1]
    runs = []
    for _ in range(2):
        port._gen.manual_seed(42)
        runs.append(spec.generate(["sampled round"], max_new_tokens=10, temperature=0.7)[0])
    assert runs[0].tokens == runs[1].tokens
    assert 1 <= len(runs[0].tokens) <= 10


def test_sampled_at_a_tiny_temperature_is_greedy(stack):
    """At temperature 1e-5 the rejection rule's draws are argmax almost
    surely: the tokens of the greedy rule."""
    _, spec = decoders(stack, "perfect", 3)
    greedy = spec.generate(["limit check"], max_new_tokens=8, temperature=0.0)
    cold = spec.generate(["limit check"], max_new_tokens=8, temperature=1e-5)
    assert greedy[0].tokens == cold[0].tokens


def test_provider_routes_chats_through_spec(stack):
    """Greedy and sampled chats of the provider both go through the
    decoder (the contiguous path's stream stays on the engine)."""
    _, spec = decoders(stack, "perfect", 3)
    provider = EngineProvider(stack[1], speculative=spec)
    stats = {}
    before = dict(spec.stats)
    text = provider.chat("route me", max_new_tokens=6, temperature=0.0, stats=stats)
    assert spec.stats["rounds"] > before["rounds"]
    plain = stack[1].generate(["route me"], max_new_tokens=6, temperature=0.0)[0]
    assert text == plain.text and stats["tokens"] == len(plain.tokens)
    before = dict(spec.stats)
    provider.chat("sampled", max_new_tokens=6, temperature=0.7)
    assert spec.stats["rounds"] > before["rounds"]
    assert isinstance("".join(provider.stream("route me", 6, 0.0)), str)


@pytest.mark.parametrize("case", ["vocab", "k"])
def test_validation_raises_the_jax_error(stack, case):
    ref, port, _ = stack
    jcfg = _f32(JLlamaConfig(vocab_size=300, dim=32, n_layers=1, n_heads=2, n_kv_heads=1,
                             mlp_dim=64, max_len=512))
    jtree = jax.tree.map(np.asarray, init_llama(jax.random.PRNGKey(1), jcfg))
    if case == "vocab":
        jargs = (ref, jtree, jcfg)
        args = (port, llama_from_jax(jtree), LlamaConfig(**dataclasses.asdict(jcfg)))
        kw = {}
    else:
        jargs, args, kw = (ref, ref.params, ref.model_config), (port, port.params,
                                                               port.model_config), {"k": 0}
    with pytest.raises(JSpeculativeError) as want:
        JDecoder(*jargs, **kw)
    with pytest.raises(SpeculativeError) as got:
        SpeculativeDecoder(*args, **kw)
    assert str(got.value) == str(want.value)


def test_moe_draft_is_not_ported(stack):
    """A draft forward of another family (JAX's MoE draft) raises,
    naming what is not ported."""
    port = stack[1]
    with pytest.raises(NotImplementedError, match="MoE"):
        SpeculativeDecoder(port, port.params, port.model_config, draft_fwd=lambda *a: None)
