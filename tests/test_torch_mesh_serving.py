"""``build_pipeline`` on a device mesh, rule by rule against JAX's
container (``sentio_tpu/serve/dependencies.py``).

Meshes are laid over ``[cpu] * k`` (a mesh may repeat a device), as JAX's
tests lay theirs over 8 virtual host devices. The weights are float32,
made by the JAX init functions from seeded keys and carried across, so a
greedy ``/chat`` is token-exact: the tp=2 pipeline must answer what the
one-device pipeline answers (which ``tests/test_torch_pipeline.py`` holds
to JAX's graph), with the same retrieved ids and scores within 1e-4.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from sentio_tpu.eval.dataset import build_bundle
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder
from sentio_tpu.models.cross_encoder import init_cross_encoder
from sentio_tpu_torch.config import (
    EmbedderConfig,
    GeneratorConfig,
    MeshConfig,
    RerankConfig,
    RetrievalConfig,
    ServeConfig,
    Settings,
)
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.models.llama import LlamaConfig
from sentio_tpu_torch.models.moe import MoeConfig
from sentio_tpu_torch.models.transformer import EncoderConfig
from sentio_tpu_torch.parallel.mesh import MeshError, build_mesh
from sentio_tpu_torch.pipeline import build_pipeline, serving_mesh
from sentio_tpu_torch.runtime import weights
from sentio_tpu_torch.serve.app import _decode_info, _device_stats
from _sanitize import _sanitized  # noqa: F401  (arms the module)


CPU = torch.device("cpu")
GEN = dict(model_preset="tiny", dtype="float32", max_new_tokens=12, verifier_max_tokens=8,
           context_token_budget=120, max_batch_size=4, kv_page_size=16,
           kv_max_pages_per_seq=32, decode_steps_per_tick=8, decode_max_tick_steps=8)
QUESTION = "Who maintains the ingest pipeline?"


def mesh_of(dp=1, tp=1, dcn=1):
    return build_mesh(MeshConfig(dp_size=dp, tp_size=tp, dcn_size=dcn),
                      devices=[CPU] * (dp * tp * dcn))


@pytest.fixture(scope="module")
def shared():
    enc = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    lcfg = dataclasses.replace(JLlamaConfig.tiny(), dtype="float32")
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(
        enc=EncoderConfig(**dataclasses.asdict(enc)),
        lcfg=LlamaConfig(**dataclasses.asdict(lcfg)),
        enc_tree=np_tree(init_encoder(jax.random.PRNGKey(31), enc)),
        ce_tree=np_tree(init_cross_encoder(jax.random.PRNGKey(32), enc)),
        llama_tree=np_tree(init_llama(jax.random.PRNGKey(33), lcfg)),
        docs=build_bundle(n_docs=12, n_queries=1, seed=3).documents,
    )


def _pipeline(shared, mesh=None, ingest=True, serve=None, llama_params=None, **gen):
    settings = Settings(
        retrieval=RetrievalConfig(strategy="hybrid", top_k=6), rerank=RerankConfig(top_k=3),
        embedder=EmbedderConfig(model_preset="tiny"),
        generator=GeneratorConfig(**dict(GEN, **gen)), serve=serve or ServeConfig())
    pipeline = build_pipeline(
        settings, device="cpu", mesh=mesh, llama_config=shared["lcfg"],
        embedder_config=shared["enc"], reranker_config=shared["enc"],
        llama_params=llama_params or weights.llama_from_jax(shared["llama_tree"]),
        embedder_params=weights.encoder_from_jax(shared["enc_tree"]),
        reranker_params=weights.cross_encoder_from_jax(shared["ce_tree"]))
    if ingest:
        pipeline.ingest([Document(text=d.text, metadata=dict(d.metadata), id=d.id)
                         for d in shared["docs"]])
    return pipeline


@pytest.fixture(scope="module")
def one_device(shared):
    pipeline = _pipeline(shared)
    yield pipeline
    pipeline.close()


def _same_chat(ref, pipeline):
    want, got = ref.chat(QUESTION, mode="fast"), pipeline.chat(QUESTION, mode="fast")
    assert got["answer"] and got["answer"] == want["answer"]
    assert got["metadata"]["retrieved_ids"] == want["metadata"]["retrieved_ids"]
    assert got["metadata"]["reranked_ids"] == want["metadata"]["reranked_ids"]
    np.testing.assert_allclose([s["score"] for s in got["sources"]],
                               [s["score"] for s in want["sources"]], atol=1e-4, rtol=0)
    assert got["verification"]["verdict"] == want["verification"]["verdict"]
    return got


def test_chat_on_a_tp2_mesh_answers_as_one_device(shared, one_device):
    """dp=2 × tp=2 with REPLICAS=2: the replicas take the two dp slices
    (each a tp=2 engine on its own shards and pools), the embedder, the
    reranker and the contiguous escape hatch shard over tp, the index by
    rows over all four coordinates; ``/info`` and ``/health`` report the
    mesh and the decode path."""
    mesh = mesh_of(dp=2, tp=2)
    pipeline = _pipeline(shared, mesh=mesh, serve=ServeConfig(replicas=2))
    try:
        _same_chat(one_device, pipeline)
        engines = [svc.engine for svc in pipeline.replica_set.services]
        assert [e.mesh.shape["dp"] for e in engines] == [1, 1]
        assert [e.tp for e in engines] == [2, 2]
        assert engines[0].sharded.tp(0)[0] is not engines[1].sharded.tp(0)[0]
        assert pipeline.mesh is mesh and pipeline.generator.provider.contiguous.mesh is mesh
        assert pipeline.embedder.params.tp == 2 and pipeline.reranker.params.tp == 2
        assert len(pipeline.index._ensure_device()[0]) == 4
        assert _device_stats(pipeline)["mesh"] == {"dcn": 1, "dp": 2, "pp": 1, "ep": 1,
                                                   "sp": 1, "tp": 2}
        assert _decode_info(pipeline) == {"tp": 2, "cuda_graphs": False}
    finally:
        pipeline.close()


def test_replicas_that_do_not_divide_dp_share_the_mesh(shared, caplog):
    """REPLICAS=3 on dp=2: JAX's warning, and every replica on the whole
    mesh (their work serializes on its devices)."""
    mesh = mesh_of(dp=2, tp=1)
    with caplog.at_level(logging.WARNING):
        pipeline = _pipeline(shared, mesh=mesh, ingest=False, serve=ServeConfig(replicas=3))
    try:
        assert "REPLICAS=3 cannot slice the dp axis" in caplog.text
        assert "replicas will share the whole mesh" in caplog.text
        assert [svc.engine.mesh for svc in pipeline.replica_set.services] == [mesh] * 3
        assert [svc.engine.tp for svc in pipeline.replica_set.services] == [1, 1, 1]
    finally:
        pipeline.close()


@pytest.mark.parametrize("mode", ["process", "socket"])
def test_worker_modes_fall_to_thread_mode_on_a_mesh(shared, caplog, mode):
    with caplog.at_level(logging.WARNING):
        pipeline = _pipeline(shared, mesh=mesh_of(tp=2), ingest=False,
                             serve=ServeConfig(replica_mode=mode))
    try:
        assert f"REPLICA_MODE={mode} ignored: a device mesh is configured" in caplog.text
        assert pipeline.replica_mode == "thread"
        assert pipeline.replica_set.services[0].engine.tp == 2
    finally:
        pipeline.close()


@pytest.mark.parametrize("paged", [True, False])
def test_a_draft_is_ignored_on_a_mesh(shared, caplog, paged):
    """Neither engine speculates on a mesh: JAX's warning, nothing loaded,
    and ``/info``'s reason."""
    with caplog.at_level(logging.WARNING):
        pipeline = _pipeline(shared, mesh=mesh_of(tp=2), ingest=False,
                             draft_checkpoint_path="/nonexistent/draft",
                             use_paged_decode=paged)
    try:
        kind = "paged" if paged else "contiguous"
        assert f"{kind} speculation does not support a device mesh yet" in caplog.text
        assert pipeline.speculative_info == {
            "draft_configured": True, "active": False,
            "ignored_reason": f"device mesh configured ({kind} speculation is single-chip)"}
        if not paged:
            assert pipeline.generator.provider.speculative is None
            assert pipeline.engine.mesh.shape["tp"] == 2
            assert pipeline.chat(QUESTION, mode="fast")["answer"] is not None
    finally:
        pipeline.close()


@pytest.mark.parametrize("fields,name", [(dict(sp_size=2), "MESH_SP=2"),
                                         (dict(pp_size=2), "MESH_PP=2"),
                                         (dict(ep_size=4), "MESH_EP=4")])
def test_sp_pp_and_ep_are_refused_naming_10b(shared, one_device, fields, name):
    """Once refused, now served. From the settings, JAX's container rule:
    sp > 1 asks for a mesh, which the one-device host cannot hold (JAX's
    ``MeshError``); pp or ep alone with ``MESH_DP`` at 0 build no mesh on
    one device, as JAX's container does, and with ``MESH_DP=1`` reach the
    same geometry check. On a caller's tp=2 mesh that repeats the CPU
    device, ``/chat`` answers as one device does: the sp mesh through the
    contiguous engine's ring prefill (the encoders on plain attention),
    pp and ep replicated beside the paged engine's tp shards."""
    with pytest.raises(MeshError, match="1 devices not divisible"):
        serving_mesh(MeshConfig(dp_size=1, **fields), CPU)
    if "sp_size" in fields:
        with pytest.raises(MeshError, match="1 devices not divisible"):
            build_pipeline(Settings(mesh=MeshConfig(**fields)), device="cpu")
    else:
        assert serving_mesh(MeshConfig(**fields), CPU) is None
    size = 2 * max(fields.values())
    mesh = build_mesh(MeshConfig(dp_size=1, tp_size=2, **fields), devices=[CPU] * size)
    paged = "sp_size" not in fields
    # the contiguous engine's answers are held to its own on one device
    ref = one_device if paged else _pipeline(shared, use_paged_decode=False)
    pipeline = _pipeline(shared, mesh=mesh, use_paged_decode=paged)
    try:
        _same_chat(ref, pipeline)
        assert pipeline.engine.mesh is mesh
        if paged:
            assert pipeline.engine.tp == 2 and pipeline.embedder.attn_fn is not None
        else:
            assert pipeline.engine.prefill_attention == "ring"
            assert pipeline.engine.ring_prefills > 0
            assert pipeline.embedder.attn_fn is None and pipeline.reranker.attn_fn is None
    finally:
        pipeline.close()
        if ref is not one_device:
            ref.close()


def test_moe_at_tp2_is_refused_naming_10b(shared):
    """Once refused, now served: a ``moe`` generator on dp=1 × ep=2 × tp=2,
    and on tp=2 alone, shards by ``MOE_EP_RULES`` and answers ``/chat`` as
    the same weights on one device do (float32, the no-drop capacity
    E / k)."""
    from sentio_tpu.models.moe import MoeConfig as JMoeConfig
    from sentio_tpu.models.moe import init_moe

    fields = dict(dataclasses.asdict(shared["lcfg"]), n_experts=4, experts_per_token=2,
                  capacity_factor=2.0)
    jtree = jax.tree.map(np.asarray, init_moe(jax.random.PRNGKey(34), JMoeConfig(**fields)))
    moe_shared = dict(shared, lcfg=MoeConfig(**fields))

    def build(mesh):
        return _pipeline(moe_shared, mesh=mesh, llama_params=weights.moe_from_jax(jtree))

    ref = build(None)
    try:
        for ep in (2, 1):
            pipeline = build(build_mesh(MeshConfig(dp_size=1, ep_size=ep, tp_size=2),
                                        devices=[CPU] * (2 * ep)))
            try:
                _same_chat(ref, pipeline)
                engine = pipeline.engine
                assert engine.tp == 2 and len(engine.params.experts) == ep
                assert sum(engine.stats()["moe_routed"]) > 0
            finally:
                pipeline.close()
    finally:
        ref.close()


def test_mesh_tp_from_the_environment_on_a_one_device_host(monkeypatch):
    """JAX's MeshError: the host's one device cannot hold tp=2."""
    monkeypatch.setenv("MESH_TP", "2")
    with pytest.raises(MeshError, match=r"1 devices not divisible by tp\*sp\*pp\*ep\*dcn=2"):
        build_pipeline(Settings.from_env(), device="cpu")
    monkeypatch.setenv("MESH_TP", "1")
    monkeypatch.setenv("MESH_DP", "2")
    with pytest.raises(MeshError, match=r"needs 2 devices, have 1"):
        build_pipeline(Settings.from_env(), device="cpu")


def test_mesh_settings_are_read_under_jaxs_names(monkeypatch):
    for name, value in (("MESH_DP", "4"), ("MESH_TP", "2"), ("MESH_SP", "1"),
                        ("MESH_PP", "3"), ("MESH_EP", "5"), ("MESH_DCN", "2"),
                        ("MESH_BACKEND", "cpu")):
        monkeypatch.setenv(name, value)
    assert Settings.from_env().mesh == MeshConfig(dp_size=4, tp_size=2, sp_size=1, pp_size=3,
                                                  ep_size=5, dcn_size=2, backend="cpu")


def test_dcn_is_an_outer_data_axis(shared, one_device):
    """dcn=2 × tp=2 on the contiguous engine: a call's two rows split over
    the two dcn coordinates, each a tp=2 group, and answer as one device."""
    mesh = mesh_of(dcn=2, tp=2)
    pipeline = _pipeline(shared, mesh=mesh, ingest=False, use_paged_decode=False)
    ref = one_device.generator.provider.contiguous
    try:
        engine = pipeline.engine
        assert [sl for sl, _ in engine._groups(2)] == [slice(0, 1), slice(1, 2)]
        prompts = ["first data row", "second data row"]
        got = engine.generate(prompts, max_new_tokens=6, temperature=0.0)
        want = ref.generate(prompts, max_new_tokens=6, temperature=0.0)
        assert [r.tokens for r in got] == [r.tokens for r in want]
    finally:
        pipeline.close()
