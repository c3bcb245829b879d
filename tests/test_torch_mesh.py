"""The port's serving mesh against JAX's, on the CPU.

JAX lays its mesh over the 8 virtual host devices of ``tests/conftest.py``;
the port lays the same geometry over ``[cpu] * k`` (a mesh may repeat a
device: every coordinate still holds its own shards and pool). Weights are
made by the JAX init functions from seeded keys and carried across with
``sentio_tpu_torch.runtime.weights``; inputs come from numpy seeds.

Tolerances: mesh geometry, shardings, shard contents, greedy tokens and
top-k ids are exact; float32 logits and encoder outputs agree within
``atol 1e-4`` (the tp sums add partial products in another order than one
matmul does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.config import EmbedderConfig as JEmbedderConfig
from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.config import MeshConfig as JMeshConfig
from sentio_tpu.config import RerankConfig as JRerankConfig
from sentio_tpu.models.cross_encoder import init_cross_encoder as jax_init_cross_encoder
from sentio_tpu.models.document import Document as JDocument
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama as jax_init_llama
from sentio_tpu.models.llama import llama_forward as jax_llama_forward
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder as jax_init_encoder
from sentio_tpu.ops.dense_index import TpuDenseIndex
from sentio_tpu.ops.embedder import TpuEmbedder
from sentio_tpu.ops.reranker import CrossEncoderReranker as JReranker
from sentio_tpu.parallel import mesh as jmesh
from sentio_tpu.parallel import sharding as jsharding
from sentio_tpu.runtime.engine import GeneratorEngine as JGeneratorEngine
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JPagedEngine
from sentio_tpu_torch.config import EmbedderConfig, GeneratorConfig, MeshConfig, RerankConfig
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig, init_tp_cache, llama_forward
from sentio_tpu_torch.models.moe import MoeConfig
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
from sentio_tpu_torch.ops.embedder import TorchEmbedder
from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
from sentio_tpu_torch.parallel import collectives
from sentio_tpu_torch.parallel import mesh as pmesh
from sentio_tpu_torch.parallel import sharding as psharding
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.weights import (
    cross_encoder_from_jax,
    encoder_from_jax,
    llama_from_jax,
)

CPU = torch.device("cpu")
LLAMA = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=128,
             max_len=512, rope_theta=10_000.0, dtype="float32")


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_mesh(dp=1, tp=1, dcn=1, k=None):
    cfg = MeshConfig(dp_size=dp, tp_size=tp, dcn_size=dcn)
    return pmesh.build_mesh(cfg, devices=[CPU] * (k or dp * tp * dcn))


def jax_mesh(dp=1, tp=1, dcn=1, k=None):
    cfg = JMeshConfig(dp_size=dp, tp_size=tp, dcn_size=dcn)
    return jmesh.build_mesh(cfg, devices=jax.devices()[: k or dp * tp * dcn])


@pytest.fixture(scope="module")
def llama():
    jcfg = JLlamaConfig(**LLAMA)
    tree = np_tree(jax_init_llama(jax.random.PRNGKey(5), jcfg))
    return jcfg, LlamaConfig(**LLAMA), tree, llama_from_jax(tree)


# ------------------------------------------------------------- geometry

GEOMETRIES = [
    (dict(), 8), (dict(tp_size=2), 8), (dict(dp_size=4, tp_size=2), 8),
    (dict(dp_size=2, tp_size=4), 8), (dict(tp_size=8), 8), (dict(dcn_size=2, tp_size=2), 8),
    (dict(dp_size=1), 1), (dict(tp_size=2), 2), (dict(sp_size=2, tp_size=2), 8),
    (dict(pp_size=2, ep_size=2), 8), (dict(dcn_size=2), 4),
    # refused: indivisible fixed axes, and a dp that does not fill the devices
    (dict(tp_size=3), 8), (dict(tp_size=2), 1), (dict(dp_size=3, tp_size=2), 8),
    (dict(dp_size=2), 1),
]


def _outcome(fn):
    try:
        return fn()
    except Exception as exc:  # the type's name and the text, compared across packages
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("fields,n", GEOMETRIES)
def test_resolve_spec_matches_jax(fields, n):
    ours = _outcome(lambda: pmesh.resolve_spec(MeshConfig(**fields), n).shape)
    ref = _outcome(lambda: jmesh.resolve_spec(JMeshConfig(**fields), n).shape)
    assert ours == ref


@pytest.mark.parametrize("fields,n", [g for g in GEOMETRIES if g[1] > 1])
def test_build_mesh_matches_jax(fields, n):
    """The same shape, axis names and device order (JAX's host devices by
    id, the port's by position) — or the same error."""
    ours = _outcome(lambda: pmesh.build_mesh(MeshConfig(**fields), devices=[CPU] * n))
    ref = _outcome(lambda: jmesh.build_mesh(JMeshConfig(**fields),
                                            devices=jax.devices()[:n]))
    if isinstance(ref, tuple):
        assert ours == ref
        return
    assert ours.shape == dict(ref.shape)
    assert ours.axis_names == tuple(ref.axis_names)
    assert all(d == CPU for d in ours.devices.flat)
    np.testing.assert_array_equal(np.vectorize(lambda d: d.id)(ref.devices),
                                  np.arange(n).reshape(ref.devices.shape))


@pytest.mark.parametrize("dp,tp,n", [(4, 2, 1), (4, 2, 2), (4, 2, 4), (2, 2, 2), (4, 2, 3),
                                     (2, 4, 4), (4, 2, 0)])
def test_split_mesh_dp_matches_jax(dp, tp, n):
    ours = _outcome(lambda: [m.shape for m in pmesh.split_mesh_dp(port_mesh(dp, tp), n)])
    ref = _outcome(lambda: [dict(m.shape) for m in
                            jmesh.split_mesh_dp(jax_mesh(dp, tp), n)])
    assert ours == ref


@pytest.mark.parametrize("dp,tp,dcn", [(8, 1, 1), (4, 2, 1), (1, 8, 1), (2, 2, 2), (1, 4, 2)])
def test_data_axes_and_batch_multiple_match_jax(dp, tp, dcn):
    ours, ref = port_mesh(dp, tp, dcn), jax_mesh(dp, tp, dcn)
    assert pmesh.data_axes(ours) == jmesh.data_axes(ref)
    assert pmesh.batch_multiple(ours) == jmesh.batch_multiple(ref)


def test_a_host_with_no_card_lays_no_default_mesh():
    """With no devices given the mesh takes every visible card; a host
    without one has none, so tp=2 is refused with JAX's text."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the mesh would take it")
    with pytest.raises(pmesh.MeshError, match="0 devices|needs 2 devices"):
        pmesh.build_mesh(MeshConfig(dp_size=1, tp_size=2))
    with pytest.raises(pmesh.MeshError, match=r"1 devices not divisible by tp\*sp\*pp\*ep"):
        pmesh.build_mesh(MeshConfig(tp_size=2, backend="cpu"))


# ------------------------------------------------------------- sharding

RULE_PATHS = ["layers_3/attn/wq/kernel", "layers_0/attn/wo/kernel", "layers_9/mlp/w_up/kernel",
              "layers_9/mlp/w_down/kernel", "embed_tokens/embedding", "lm_head/kernel",
              "final_norm/scale", "something/unmatched", "layers_0/moe/w_gate",
              "layers_0/moe/w_down", "layers_0/moe/router/kernel",
              "encoder/layers_1/attn/wk/bias", "encoder/embed_positions/embedding",
              "layers_0/mlp/w_in/kernel", "layers_0/mlp/w_out/kernel", "head/kernel"]


@pytest.mark.parametrize("rules", ["LLAMA_TP_RULES", "MOE_EP_RULES", "ENCODER_TP_RULES"])
@pytest.mark.parametrize("path", RULE_PATHS)
def test_rules_resolve_as_jax(rules, path):
    for ndim in (1, 2, 3):
        ours = psharding.spec_for(path, getattr(psharding, rules), ndim)
        ref = jsharding.spec_for(path, getattr(jsharding, rules), ndim)
        assert str(ours) == str(ref)
        assert tuple(ours) == tuple(ref)


def _jax_trees(which):
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    if which == "llama":
        tree = np_tree(jax_init_llama(jax.random.PRNGKey(1), JLlamaConfig.tiny()))
        return tree, llama_from_jax(tree), "LLAMA_TP_RULES"
    if which == "encoder":
        tree = np_tree(jax_init_encoder(jax.random.PRNGKey(2), enc))
        return tree, encoder_from_jax(tree), "ENCODER_TP_RULES"
    tree = np_tree(jax_init_cross_encoder(jax.random.PRNGKey(3), enc))
    return tree, cross_encoder_from_jax(tree), "ENCODER_TP_RULES"


@pytest.mark.parametrize("which", ["llama", "encoder", "cross_encoder"])
def test_describe_shardings_matches_jax(which):
    jtree, tree, rules = _jax_trees(which)
    ours = psharding.describe_shardings(tree, port_mesh(4, 2), getattr(psharding, rules))
    ref = jsharding.describe_shardings(jtree, jax_mesh(4, 2), getattr(jsharding, rules))
    assert ours == ref


@pytest.mark.parametrize("which", ["llama", "encoder", "cross_encoder"])
def test_every_shard_equals_jaxs_addressable_shard(which):
    """Each port coordinate's tensor equals JAX's shard on the device at
    that coordinate (a dense weight transposed), and is contiguous."""
    jtree, tree, rules = _jax_trees(which)
    jm, pm = jax_mesh(4, 2), port_mesh(4, 2)
    placed = jsharding.shard_params(jtree, jm, getattr(jsharding, rules))
    ours = psharding.shard_params(tree, pm, getattr(psharding, rules))
    coord_of = {d.id: tuple(int(i) for i in np.argwhere(np.vectorize(lambda x: x.id)(
        jm.devices) == d.id)[0]) for d in jm.devices.flat}
    port_leaves = {psharding.jax_path(p): p for p, _ in psharding.leaves(tree)}
    n = 0
    for path, leaf in jax.tree_util.tree_leaves_with_path(placed):
        jpath = jsharding.path_str(path)
        for shard in leaf.addressable_shards:
            mine = ours.trees[coord_of[shard.device.id]]
            for key in port_leaves[jpath].split("/"):
                mine = mine[key]
            want = np.asarray(shard.data)
            if jpath.endswith("/kernel"):
                want = want.T
            assert mine.is_contiguous()
            np.testing.assert_array_equal(mine.numpy(), want, err_msg=jpath)
            n += 1
    assert n == 8 * len(port_leaves)


def test_split_hands_each_dp_slice_its_own_shards(llama):
    _, _, _, tree = llama
    sharded = psharding.shard_params(tree, port_mesh(4, 2), psharding.LLAMA_TP_RULES)
    parts = sharded.split(2)
    assert [p.mesh.shape["dp"] for p in parts] == [2, 2]
    for i, part in enumerate(parts):
        for row in range(2):
            assert all(a is b for a, b in zip(part.tp(row), sharded.tp(2 * i + row)))


def test_a_whole_replicated_leaf_is_its_source(llama):
    """Shards that are the whole tensor on its own device are the tensor:
    a mesh that repeats a device holds replicated leaves once."""
    _, _, _, tree = llama
    sharded = psharding.shard_params(tree, port_mesh(4, 2), psharding.LLAMA_TP_RULES)
    for coord, shard in sharded.trees.items():
        assert shard["final_norm"]["scale"] is tree["final_norm"]["scale"]
        assert shard["layers_1"]["mlp_norm"]["scale"] is tree["layers_1"]["mlp_norm"]["scale"]
    wq = tree["layers_0"]["attn"]["wq"]["weight"]
    halves = [sharded.tp(0)[t]["layers_0"]["attn"]["wq"]["weight"] for t in range(2)]
    torch.testing.assert_close(torch.cat(halves), wq, rtol=0, atol=0)


def test_collectives_sum_in_tp_order_and_gather():
    parts = [torch.full((2, 3), float(i + 1)) for i in range(3)]
    torch.testing.assert_close(collectives.psum(parts, CPU), torch.full((2, 3), 6.0))
    torch.testing.assert_close(collectives.all_gather(parts, CPU, dim=0)[:, 0],
                               torch.tensor([1.0, 1.0, 2.0, 2.0, 3.0, 3.0]))
    x = torch.arange(4.0)
    assert all(y is x for y in collectives.broadcast(x, [CPU, CPU]))


# ------------------------------------------------------------- the models


@pytest.mark.parametrize("dp,tp", [(1, 2), (4, 2), (2, 2)])
def test_tp_forward_matches_jaxs_sharded_forward(llama, dp, tp):
    """``llama_forward`` over tp shards against JAX's forward on the
    sharded tree (``tests/test_parallel.py``'s check), float32, atol 1e-4."""
    jcfg, cfg, jtree, tree = llama
    ids = np.random.default_rng(1).integers(1, 500, (4, 8)).astype(np.int32)
    jm = jax_mesh(dp, tp)
    placed = jsharding.shard_params(jtree, jm, jsharding.LLAMA_TP_RULES)
    ref, _ = jax_llama_forward(placed, jcfg, jax.device_put(
        jnp.asarray(ids), jsharding.batch_sharding(jm)))
    sharded = psharding.shard_params(tree, port_mesh(dp, tp), psharding.LLAMA_TP_RULES)
    for row in range(dp):
        out, _ = llama_forward(sharded.tp(row), cfg, torch.as_tensor(ids))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4, rtol=0)


def test_tp_prefill_with_cache_matches_one_device(llama):
    """A prefill into per-shard caches (each with Hkv/tp heads) and a decode
    step over them give the one-device forward's logits, atol 1e-4; the
    shards' caches are the one-device cache's heads."""
    _, cfg, _, tree = llama
    from sentio_tpu_torch.models.llama import init_cache

    shards = psharding.shard_params(tree, port_mesh(1, 2), psharding.LLAMA_TP_RULES).tp(0)
    ids = torch.as_tensor(np.random.default_rng(2).integers(1, 500, (2, 6)))
    pad = torch.tensor([[True] * 6, [True] * 4 + [False] * 2])
    one = init_cache(cfg, 2, 16, CPU)
    ref, _ = llama_forward(tree, cfg, ids, cache=one, pad_mask=pad)
    caches = init_tp_cache(cfg, 2, 16, shards)
    assert [c["k"].shape[3] for c in caches] == [1, 1]
    out, _ = llama_forward(shards, cfg, ids, cache=caches, pad_mask=pad)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=0)
    torch.testing.assert_close(torch.cat([c["k"] for c in caches], dim=3), one["k"],
                               atol=1e-5, rtol=0)
    lens = torch.tensor([6, 4])
    tok = torch.tensor([[7], [9]])
    ref, _ = llama_forward(tree, cfg, tok, positions=lens[:, None], cache=one, cache_index=lens)
    out, _ = llama_forward(shards, cfg, tok, positions=lens[:, None], cache=caches,
                           cache_index=lens)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=0)


# ------------------------------------------------------------- engines

HEAD = "You answer from the numbered sources below and cite them. " * 2
PROMPTS = ["mesh request one", HEAD + "what is a page?", HEAD + "who owns a slot?",
           "a longer mesh request that spans more than one page of the cache " * 2]
ENGINE = dict(max_slots=4, page_size=16, max_pages_per_seq=16, steps_per_tick=4)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_engine_on_a_mesh_matches_jaxs(llama, kv_quant):
    """dp=4, tp=2: greedy tokens equal JAX's mesh engine (its XLA gather
    path), with radix hits on the shared head (prior pages gathered per
    shard); the pool is one contiguous tensor per tp shard with Hkv/tp
    heads, and the whole pool's bytes are the one-device pool's."""
    jcfg, cfg, jtree, tree = llama
    jm = jax_mesh(4, 2)
    jeng = JPagedEngine(model_config=jcfg, params=jsharding.shard_params(
        jtree, jm, jsharding.LLAMA_TP_RULES), mesh=jm, kv_quant=kv_quant, **ENGINE)
    jeng.warm_prefix(HEAD)
    ref = jeng.run_all(PROMPTS[:3], max_new_tokens=6, temperature=0.0)
    eng = ContinuousBatchingEngine(model_config=cfg, params=tree, mesh=port_mesh(4, 2),
                                   kv_quant=kv_quant, device="cpu", **ENGINE)
    eng.warm_prefix(HEAD)
    got = eng.run_all(PROMPTS[:3], max_new_tokens=6, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in ref]
    stats = eng.stats()
    assert eng.tp == 2 and stats["prefix_hit_tokens"] > 0
    one = ContinuousBatchingEngine(model_config=cfg, params=tree, kv_quant=kv_quant,
                                   device="cpu", **ENGINE)
    assert stats["pool_hbm_bytes"] == one.stats()["pool_hbm_bytes"]
    for pool in eng.pool.shards:
        for t in ((pool.k.q, pool.k.s) if kv_quant == "int8" else (pool.k,)):
            assert t.is_contiguous() and t.shape[3] == cfg.n_kv_heads // 2


def test_chunked_prefill_and_reset_on_a_mesh(llama):
    """A chunked admission (each segment over its prior pages) and a reset
    keep the tp=2 engine's greedy tokens equal to the one-device engine's."""
    _, cfg, _, tree = llama
    kw = dict(ENGINE, prefill_chunk=32, steps_per_tick=8)
    eng = ContinuousBatchingEngine(model_config=cfg, params=tree, mesh=port_mesh(1, 2),
                                   device="cpu", **kw)
    one = ContinuousBatchingEngine(model_config=cfg, params=tree, device="cpu", **kw)
    ref = [r.tokens for r in one.run_all(PROMPTS[3:], max_new_tokens=6)]
    assert [r.tokens for r in eng.run_all(PROMPTS[3:], max_new_tokens=6)] == ref
    eng.reset()
    assert [r.tokens for r in eng.run_all(PROMPTS[3:], max_new_tokens=6)] == ref
    fresh = eng.spawn_fresh()
    assert fresh.tp == 2 and fresh.sharded is eng.sharded and fresh.pool is not eng.pool


def test_kv_heads_not_divisible_by_tp_raises(llama):
    """JAX's ``ValueError`` (tiny has 2 kv heads; tp=4)."""
    _, cfg, _, tree = llama
    with pytest.raises(ValueError, match="n_kv_heads=2 not divisible by tp=4"):
        ContinuousBatchingEngine(model_config=cfg, params=tree, mesh=port_mesh(2, 4),
                                 device="cpu", max_slots=2)


def test_engines_refuse_what_the_serving_mesh_is_not(llama):
    """Every axis is served now: a MoE model at tp > 1 shards by
    ``MOE_EP_RULES`` (its experts' products over tp), the contiguous engine
    on an sp mesh prefills on the ring, pp and ep replicate a llama model.
    What stays refused is a draft on a mesh (JAX's paged speculation is
    single-chip)."""
    _, cfg, _, tree = llama
    moe_engine = ContinuousBatchingEngine(model_config=MoeConfig.tiny(), mesh=port_mesh(1, 2),
                                          device="cpu")
    assert moe_engine.tp == 2 and moe_engine.sharded.rules is psharding.MOE_EP_RULES
    assert moe_engine.params[1]["layers_0"]["moe"]["w_gate"].shape == (4, 64, 64)
    sp = pmesh.build_mesh(MeshConfig(dp_size=1, sp_size=2), devices=[CPU] * 2)
    assert GeneratorEngine(model_config=cfg, params=tree, mesh=sp).prefill_attention == "ring"
    pp_ep = pmesh.build_mesh(MeshConfig(dp_size=1, pp_size=2, ep_size=2), devices=[CPU] * 4)
    replicated = ContinuousBatchingEngine(model_config=cfg, params=tree, mesh=pp_ep,
                                          device="cpu", max_slots=2)
    assert replicated.tp == 1 and not replicated.sharded_compute
    with pytest.raises(ValueError, match="does not support a mesh"):
        ContinuousBatchingEngine(model_config=cfg, params=tree, mesh=port_mesh(1, 2),
                                 device="cpu", draft_params=tree, draft_config=cfg)


@pytest.mark.parametrize("dp,tp,n", [(4, 2, 4), (1, 2, 1), (4, 2, 1)])
def test_contiguous_engine_on_a_mesh(llama, dp, tp, n):
    """Greedy tokens at float32: against JAX's mesh engine where JAX can
    place the cache (rows divisible by dp), else against the one-device
    engine (JAX's ``device_put`` of a 1-row cache over dp=4 raises; the
    port runs such a call on the first data coordinate); ``device_stats``
    gives the mesh."""
    jcfg, cfg, jtree, tree = llama
    gcfg = dict(provider="tpu", model_preset="tiny", max_new_tokens=6)
    eng = GeneratorEngine(config=GeneratorConfig(**gcfg), model_config=cfg, params=tree,
                          mesh=port_mesh(dp, tp))
    got = [r.tokens for r in eng.generate(PROMPTS[:n], max_new_tokens=6, temperature=0.0)]
    if n % dp == 0:
        jeng = JGeneratorEngine(config=JGeneratorConfig(**gcfg), model_config=jcfg,
                                params=jtree, mesh=jax_mesh(dp, tp))
        ref = [r.tokens for r in jeng.generate(PROMPTS[:n], max_new_tokens=6,
                                               temperature=0.0)]
    else:
        one = GeneratorEngine(config=GeneratorConfig(**gcfg), model_config=cfg, params=tree,
                              device="cpu")
        ref = [r.tokens for r in one.generate(PROMPTS[:n], max_new_tokens=6,
                                              temperature=0.0)]
    assert got == ref
    assert eng.device_stats()["mesh"] == {"dcn": 1, "dp": dp, "pp": 1, "ep": 1, "sp": 1,
                                          "tp": tp}
    streamed = "".join(eng.stream(PROMPTS[0], max_new_tokens=6, temperature=0.0))
    assert streamed == eng.tokenizer.decode(got[0])


# ------------------------------------------------------------- encoders

TEXTS = ["the quick brown fox", "jumps over", "the lazy dog and some more words here"]


@pytest.mark.parametrize("heads", [4, 3], ids=["per_shard_heads", "heads_split"])
def test_encoders_on_a_mesh_match_jax(heads):
    """dp=4, tp=2, float32, atol 1e-4: the embedder's vectors and the
    cross-encoder's scores against JAX's on the same mesh. With 4 heads each
    shard attends its own 2 (the flash seam per shard); with 3, the heads
    split within a shard and attention is plain over every head, by JAX's
    ``select_encoder_attn_fn``."""
    kw = dict(vocab_size=512, dim=48, n_layers=2, n_heads=heads, mlp_dim=96, max_len=128,
              dtype="float32")
    jcfg, cfg = JEncoderConfig(**kw), EncoderConfig(**kw)
    jm, pm = jax_mesh(4, 2), port_mesh(4, 2)
    enc = np_tree(jax_init_encoder(jax.random.PRNGKey(8), jcfg))
    ref = TpuEmbedder(JEmbedderConfig(model_preset="tiny", coalesce=False, cache_size=0),
                      params=enc, model_config=jcfg, mesh=jm).embed_many(TEXTS)
    emb = TorchEmbedder(EmbedderConfig(model_preset="tiny", coalesce=False, cache_size=0),
                        params=encoder_from_jax(enc), model_config=cfg, mesh=pm)
    np.testing.assert_allclose(emb.embed_many(TEXTS), ref, atol=1e-4, rtol=0)
    assert (emb.attn_fn is None) == (heads % 2 != 0)

    ce = np_tree(jax_init_cross_encoder(jax.random.PRNGKey(9), jcfg))
    jdocs = [JDocument(text=t, id=str(i)) for i, t in enumerate(TEXTS)]
    docs = [Document(text=t, id=str(i)) for i, t in enumerate(TEXTS)]
    ref = JReranker(JRerankConfig(), params=ce, model_config=jcfg, mesh=jm)._score("fox", jdocs)
    got = CrossEncoderReranker(RerankConfig(), params=cross_encoder_from_jax(ce),
                               model_config=cfg, mesh=pm)._score("fox", docs)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4, rtol=0)


# ------------------------------------------------------------- dense index


def _corpus(n, dim, seed):
    embs = np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)
    return [f"d{i}" for i in range(n)], embs


@pytest.mark.parametrize("n,dim,k", [(40, 16, 7), (3, 8, 3), (100, 16, 50)])
def test_row_sharded_index_matches_jax(n, dim, k):
    """An index sharded over 8 coordinates returns JAX's sharded ids and
    scores (``tests/test_dense_index.py``'s check), a corpus smaller than
    the shard count included; upserts and deletes rebuild the blocks."""
    ids, embs = _corpus(n, dim, seed=3)
    ref = TpuDenseIndex(dim=dim, mesh=jax_mesh(8), dtype="float32")
    ref.add([JDocument(text=i, id=i) for i in ids], embs)
    ours = TorchDenseIndex(dim=dim, mesh=port_mesh(8), dtype="float32")
    ours.add([Document(text=i, id=i) for i in ids], embs)
    assert len(ours._ensure_device()[0]) == 8
    for q in np.random.default_rng(4).standard_normal((3, dim)).astype(np.float32):
        a = [(d.id, round(s, 4)) for d, s in ref.search(q, k)]
        b = [(d.id, round(s, 4)) for d, s in ours.search(q, k)]
        assert a == b
    ours.delete(ids[:1])
    ref.delete(ids[:1])
    q = embs[-1]
    assert [d.id for d, _ in ours.search(q, k)] == [d.id for d, _ in ref.search(q, k)]
