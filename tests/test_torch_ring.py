"""Ring attention over ``sp`` (``kernels/ring_attention.py``) and the mesh
attention adapters (``kernels/__init__.py``) against JAX's, on the CPU;
then the sequence-parallel serving paths: the contiguous engine's ring
prefill, the paged engine's ``forward_fn`` seam, and the encoders' policy
at sp > 1.

JAX runs on the 8 virtual host devices of ``tests/conftest.py``; the port
lays the same geometry over ``[cpu] * k``. Inputs come from numpy seeds.
Tolerances: float32 attention outputs atol 2e-5 (2e-4 where JAX's own
test of the adapter allows it); greedy tokens exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.config import MeshConfig as JMeshConfig
from sentio_tpu.kernels import make_mesh_attn_fn as jax_make_mesh_attn_fn
from sentio_tpu.kernels.ring_attention import ring_attention_sharded as jax_ring_sharded
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama as jax_init_llama
from sentio_tpu.models.layers import attention as jax_attention
from sentio_tpu.models.layers import causal_mask as jax_causal_mask
from sentio_tpu.parallel import mesh as jmesh
from sentio_tpu.runtime.engine import GeneratorEngine as JGeneratorEngine
from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu_torch.config import GeneratorConfig, MeshConfig
from sentio_tpu_torch.kernels import (
    encoder_attn_fn,
    make_mesh_attn_fn,
    make_ring_attn_fn,
    ring_attention_sharded,
    select_encoder_attn_fn,
)
from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.llama import LlamaConfig, llama_forward
from sentio_tpu_torch.parallel import mesh as pmesh
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.weights import llama_from_jax

CPU = torch.device("cpu")
LLAMA = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=128,
             max_len=512, rope_theta=10_000.0, dtype="float32")


def port_mesh(**fields):
    n = int(np.prod(list(fields.values())))
    return pmesh.build_mesh(MeshConfig(**fields), devices=[CPU] * n)


def jax_mesh(**fields):
    n = int(np.prod(list(fields.values())))
    return jmesh.build_mesh(JMeshConfig(**fields), devices=jax.devices()[:n])


def qkv(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32) for _ in range(3)]


def torch_of(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------- the ring itself


@pytest.mark.parametrize("sp,dp", [(2, 2), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_attention_sharded_matches_jax(sp, dp, causal):
    """JAX's ``ring_attention_sharded`` on the same arrays: the batch over
    dp, the sequence over sp chunks rotating around the ring."""
    q, k, v = qkv(dp * 2, 16 * sp, 2, 16, seed=sp + causal)
    ref = jax_ring_sharded(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jax_mesh(dp_size=dp, sp_size=sp), causal=causal)
    got = ring_attention_sharded(*torch_of(q, k, v), port_mesh(dp_size=dp, sp_size=sp),
                                 causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=0)


@pytest.mark.parametrize("sp", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_ring_masks_keys_past_kv_lens(sp, causal):
    """``kv_lens`` masks keys by global position (JAX's ring under its
    mesh adapter reads it so); against plain masked attention on the rows'
    valid queries, and a row with no valid key is 0 (the ``l == 0``
    guard)."""
    t = 8 * sp
    q, k, v = qkv(3, t, 2, 16, seed=20 + sp)
    lens = np.array([t, t // 2 + 1, 0], np.int32)
    got = ring_attention_sharded(*torch_of(q, k, v), port_mesh(sp_size=sp), causal=causal,
                                 kv_lens=torch.from_numpy(lens)).numpy()
    mask = jax_causal_mask(t) if causal else jnp.ones((1, 1, t, t), bool)
    mask = mask & (jnp.arange(t)[None, :] < jnp.asarray(lens)[:, None])[:, None, None, :]
    ref = np.asarray(jax_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask,
                                   jnp.float32))
    for row in range(2):
        n = int(lens[row])
        np.testing.assert_allclose(got[row, :n], ref[row, :n], atol=2e-5, rtol=0)
    assert not got[2].any()


def test_ring_rejects_a_sequence_that_does_not_divide():
    q, k, v = torch_of(*qkv(2, 30, 2, 16))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention_sharded(q, k, v, port_mesh(dp_size=2, sp_size=4))
    with pytest.raises(ValueError, match="not divisible"):
        make_ring_attn_fn([CPU] * 4)(q, k, v)


def test_ring_over_a_cache_window_leaves_the_tail_out():
    """A prefill's keys span the cache window (S > T, the tail unwritten):
    no query attends past T, so the ring reads the first T keys only."""
    q, k, v = torch_of(*qkv(2, 32, 2, 16, seed=3))
    tail = torch.randn(2, 32, 2, 16)
    got = make_ring_attn_fn([CPU] * 4)(q, torch.cat([k, tail], 1), torch.cat([v, tail], 1))
    want = L.attention(q, k, v, L.causal_mask(32), torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)


# ---------------------------------------------------- the mesh adapter


@pytest.mark.parametrize("fields,lens", [
    (dict(dp_size=4, sp_size=1, tp_size=2), None),
    (dict(dp_size=2, sp_size=2, tp_size=2), None),
    (dict(dp_size=2, sp_size=2, tp_size=2), [20, 9]),
    (dict(dp_size=1, sp_size=4, tp_size=2), [32, 17]),
], ids=["dp4_tp2_flash", "dp2_sp2_tp2_ring", "ring_kv_lens", "sp4_tp2_ring_kv_lens"])
def test_make_mesh_attn_fn_matches_jax(fields, lens):
    """Heads over tp, the sequence over sp, the batch over dp: JAX's adapter
    on the same arrays (its flash at sp 1 in interpret mode, its ring at
    sp > 1), compared on each row's valid queries."""
    b = 4 if fields["dp_size"] == 4 else 2
    q, k, v = qkv(b, 32, 4, 16, seed=11)
    jlens = None if lens is None else jnp.asarray(lens, jnp.int32)
    ref = np.asarray(jax_make_mesh_attn_fn(jax_mesh(**fields))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jlens))
    got = make_mesh_attn_fn(port_mesh(**fields))(
        *torch_of(q, k, v), None if lens is None else torch.tensor(lens, dtype=torch.int32))
    for row in range(b):
        n = 32 if lens is None else lens[row]
        np.testing.assert_allclose(got.numpy()[row, :n], ref[row, :n], atol=2e-4, rtol=0)


def test_make_mesh_attn_fn_refusals():
    """Heads that do not divide over tp, a sequence that does not divide
    over sp (JAX's ``ValueError``s), and a bidirectional ring."""
    fn = make_mesh_attn_fn(port_mesh(sp_size=2, tp_size=4))
    q, k, v = torch_of(*qkv(2, 32, 6, 16))
    with pytest.raises(ValueError, match="heads 6 % tp 4"):
        fn(q, k, v)
    q, k, v = torch_of(*qkv(2, 31, 8, 16))
    with pytest.raises(ValueError, match="seq 31 % sp 2"):
        fn(q, k, v)
    with pytest.raises(ValueError, match="causal-only"):
        make_mesh_attn_fn(port_mesh(sp_size=2), causal=False)


# ---------------------------------------------------- serving over sp


@pytest.fixture(scope="module")
def llama():
    jcfg = JLlamaConfig(**LLAMA)
    tree = jax.tree.map(np.asarray, jax_init_llama(jax.random.PRNGKey(21), jcfg))
    return jcfg, LlamaConfig(**LLAMA), tree


PROMPTS = ["a ring of sequence chunks " * 6, "short"]


def test_contiguous_engine_rides_the_ring_at_sp2(llama):
    """sp=2 × tp=2: the prefill's attention is the ring (JAX's choice on a
    sequence mesh), and the greedy tokens are JAX's engine's on one
    device, whose attention is plain."""
    jcfg, cfg, tree = llama
    gen = dict(model_preset="tiny", max_new_tokens=8)
    ref = JGeneratorEngine(JGeneratorConfig(**gen), model_config=jcfg,
                           params=jax.tree.map(jnp.asarray, tree))
    want = ref.generate(PROMPTS, temperature=0.0)
    engine = GeneratorEngine(GeneratorConfig(**gen), model_config=cfg,
                             params=llama_from_jax(tree), mesh=port_mesh(sp_size=2, tp_size=2))
    got = engine.generate(PROMPTS, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert engine.prefill_attention == "ring" and engine.ring_prefills == 1


def test_prefill_attention_is_decided_by_shape(llama):
    """Where JAX's adapter raises and JAX falls back to plain attention,
    the port tests the shape first: a width that does not divide over sp
    runs plain attention; one that does, the ring."""
    _, cfg, tree = llama
    engine = GeneratorEngine(GeneratorConfig(model_preset="tiny"), model_config=cfg,
                             params=llama_from_jax(tree), mesh=port_mesh(sp_size=4))
    assert engine.prefill_attn_fn(64) is engine.attn_fn
    assert engine.prefill_attn_fn(66) is None
    single = GeneratorEngine(GeneratorConfig(model_preset="tiny"), model_config=cfg,
                             params=llama_from_jax(tree), device="cpu")
    assert single.prefill_attention == "plain" and single.prefill_attn_fn(64) is None


def test_paged_engine_with_a_ring_forward_fn(llama):
    """JAX's long-context case: ``partial(llama_forward,
    attn_fn=make_mesh_attn_fn(mesh))`` on a dp × sp × tp mesh runs the
    prefill's attention on the ring and emits the single-device engine's
    greedy tokens; a second prompt sharing the first's head prefills over
    prior pages, with plain attention."""
    _, cfg, tree = llama
    mesh = port_mesh(dp_size=2, sp_size=2, tp_size=2)
    geometry = dict(max_slots=2, page_size=16, max_pages_per_seq=16, ignore_eos=True,
                    device="cpu")
    prompts = [PROMPTS[0] * 3, PROMPTS[0] * 3 + "and a tail"]
    want = ContinuousBatchingEngine(model_config=cfg, params=llama_from_jax(tree),
                                    **geometry).run_all(prompts, max_new_tokens=8)
    calls = []
    ring = make_mesh_attn_fn(mesh)
    shard = ring.shard
    ring.shard = lambda *a: calls.append(a[0].shape[1]) or shard(*a)
    engine = ContinuousBatchingEngine(
        model_config=cfg, params=llama_from_jax(tree), mesh=mesh,
        forward_fn=functools.partial(llama_forward, attn_fn=ring), **geometry)
    got = engine.run_all(prompts, max_new_tokens=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert calls and engine.tp == 2


def test_encoders_run_plain_attention_at_sp2():
    """JAX's ``select_encoder_attn_fn``: the bidirectional kernel only where
    sp = 1 and tp divides the heads."""
    assert select_encoder_attn_fn(None, 4) is encoder_attn_fn
    assert select_encoder_attn_fn(port_mesh(tp_size=2), 4) is encoder_attn_fn
    assert select_encoder_attn_fn(port_mesh(tp_size=2), 3) is None
    assert select_encoder_attn_fn(port_mesh(sp_size=2), 4) is None
    assert select_encoder_attn_fn(port_mesh(sp_size=2, tp_size=2), 4) is None


def test_encoders_on_an_sp_mesh_match_jax():
    """The embedder and the cross-encoder on sp=2 × tp=2: plain attention
    over each tp shard's heads; vectors and scores against JAX's on the
    same mesh (atol 1e-4, as on a tp mesh)."""
    from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
    from sentio_tpu.config import RerankConfig as JRerankConfig
    from sentio_tpu.models.cross_encoder import init_cross_encoder
    from sentio_tpu.models.document import Document as JDocument
    from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
    from sentio_tpu.models.transformer import init_encoder
    from sentio_tpu.ops.embedder import TpuEmbedder
    from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
    from sentio_tpu_torch.config import EmbedderConfig, RerankConfig
    from sentio_tpu_torch.models.document import Document
    from sentio_tpu_torch.models.transformer import EncoderConfig
    from sentio_tpu_torch.ops.embedder import TorchEmbedder
    from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
    from sentio_tpu_torch.runtime.weights import cross_encoder_from_jax, encoder_from_jax

    kw = dict(vocab_size=512, dim=48, n_layers=2, n_heads=4, mlp_dim=96, max_len=128,
              dtype="float32")
    jcfg, cfg = JEncoderConfig(**kw), EncoderConfig(**kw)
    jm, pm = jax_mesh(sp_size=2, tp_size=2), port_mesh(sp_size=2, tp_size=2)
    texts = ["sequence parallel encoders", "plain attention at sp two", "x"]
    enc = jax.tree.map(np.asarray, init_encoder(jax.random.PRNGKey(4), jcfg))
    econf = dict(model_preset="tiny", coalesce=False, cache_size=0)
    ref = TpuEmbedder(JEmbedderConfig(**econf), params=enc, model_config=jcfg,
                      mesh=jm).embed_many(texts)
    emb = TorchEmbedder(EmbedderConfig(**econf), params=encoder_from_jax(enc),
                        model_config=cfg, mesh=pm)
    assert emb.attn_fn is None and emb.params.tp == 2
    np.testing.assert_allclose(emb.embed_many(texts), ref, atol=1e-4, rtol=0)

    ce = jax.tree.map(np.asarray, init_cross_encoder(jax.random.PRNGKey(5), jcfg))
    ref = JReranker(JRerankConfig(), params=ce, model_config=jcfg, mesh=jm)._score(
        "ring", [JDocument(text=t, id=str(i)) for i, t in enumerate(texts)])
    rer = CrossEncoderReranker(RerankConfig(), params=cross_encoder_from_jax(ce),
                               model_config=cfg, mesh=pm)
    assert rer.attn_fn is None
    got = rer._score("ring", [Document(text=t, id=str(i)) for i, t in enumerate(texts)])
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=0)
