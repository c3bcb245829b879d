"""Encoder, cross-encoder and Llama prefill in the port against the JAX
package, on weights made by the JAX init functions and carried across by
sentio_tpu_torch.runtime.weights.

Tolerances: atol 1e-4 in float32 (the same network, summed in another
order, through a few layers). In bfloat16 both sides round every matmul
output and activation to 8 bits of mantissa at slightly different places,
so logits are held at atol 0.1 against each other (about 3% of their
spread) and the greedy token must agree."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.kernels import encoder_attn_fn as jax_encoder_attn
from sentio_tpu.models import cross_encoder as jce
from sentio_tpu.models import llama as jllama
from sentio_tpu.models import transformer as jtr
from sentio_tpu_torch.kernels import encoder_attn_fn
from sentio_tpu_torch.models import cross_encoder as tce
from sentio_tpu_torch.models import llama as tllama
from sentio_tpu_torch.models import transformer as ttr
from sentio_tpu_torch.runtime import weights

ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _enc_cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jtr.EncoderConfig.tiny(), dtype=dtype)
    return jcfg, ttr.EncoderConfig(**dataclasses.asdict(jcfg))


def _enc_inputs(seed=0, with_empty_row=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 500, (4, 24)).astype(np.int32)
    mask = np.zeros((4, 24), bool)
    for row, n in enumerate([24, 11, 3, 0 if with_empty_row else 17]):
        mask[row, :n] = True
    types = (np.arange(24)[None, :] >= 8).astype(np.int32).repeat(4, 0)
    return ids, mask, types


def test_weights_transpose_dense_kernels_once():
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype="float32")
    tree = _np_tree(jllama.init_llama(jax.random.PRNGKey(0), jcfg))
    params = weights.llama_from_jax(tree)
    wq = tree["layers_1"]["attn"]["wq"]["kernel"]  # [in, out]
    np.testing.assert_array_equal(params["layers_1"]["attn"]["wq"]["weight"].numpy(), wq.T)
    np.testing.assert_array_equal(params["embed_tokens"]["embedding"].numpy(),
                                  tree["embed_tokens"]["embedding"])
    assert params["final_norm"]["scale"].dtype == torch.float32
    bf16 = weights.llama_from_jax(tree, dtype=torch.bfloat16)
    assert bf16["lm_head"]["weight"].dtype == torch.bfloat16
    assert bf16["layers_0"]["attn_norm"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("kernel", [False, True], ids=["plain_attention", "flash"])
def test_encoder_forward_and_pool(kernel):
    jcfg, tcfg = _enc_cfgs()
    tree = _np_tree(jtr.init_encoder(jax.random.PRNGKey(1), jcfg))
    params = weights.encoder_from_jax(tree)
    # the flash path holds a row with no real token: both kernels write 0
    ids, mask, types = _enc_inputs(seed=2, with_empty_row=kernel)
    ref = jtr.encoder_forward(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                              jnp.asarray(types),
                              attn_fn=jax_encoder_attn if kernel else None)
    got = ttr.encoder_forward(params, tcfg, torch.from_numpy(ids), torch.from_numpy(mask),
                              torch.from_numpy(types),
                              attn_fn=encoder_attn_fn if kernel else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(ttr.mean_pool(got, torch.from_numpy(mask)).numpy(),
                               np.asarray(jtr.mean_pool(ref, jnp.asarray(mask))),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("pooler", [False, True])
def test_cross_encoder_scores(pooler):
    jcfg, tcfg = _enc_cfgs()
    tree = _np_tree(jce.init_cross_encoder(jax.random.PRNGKey(3), jcfg))
    if pooler:
        rng = np.random.default_rng(4)
        tree["pooler"] = {"kernel": rng.standard_normal((64, 64)).astype(np.float32) * 0.1,
                          "bias": rng.standard_normal(64).astype(np.float32) * 0.1}
    params = weights.cross_encoder_from_jax(tree)
    ids, mask, types = _enc_inputs(seed=5)
    ref = jce.cross_encoder_scores(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                   jnp.asarray(types), attn_fn=jax_encoder_attn)
    got = tce.cross_encoder_scores(params, tcfg, torch.from_numpy(ids),
                                   torch.from_numpy(mask), torch.from_numpy(types),
                                   attn_fn=encoder_attn_fn)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def _llama(dtype):
    jcfg = dataclasses.replace(jllama.LlamaConfig.tiny(), dtype=dtype)
    tcfg = tllama.LlamaConfig(**dataclasses.asdict(jcfg))
    tree = _np_tree(jllama.init_llama(jax.random.PRNGKey(5), dataclasses.replace(
        jcfg, dtype="float32")))
    params = weights.llama_from_jax(tree, dtype=getattr(torch, dtype))
    return jcfg, tcfg, tree, params


def _prefill(jcfg, tcfg, tree, params, ids):
    b, t = ids.shape
    jcache = jllama.init_cache(jcfg, b, 64)
    ref, jcache = jllama.llama_forward(tree, jcfg, jnp.asarray(ids),
                                       positions=jnp.broadcast_to(jnp.arange(t), (b, t)),
                                       cache=jcache, cache_index=0)
    tcache = tllama.init_cache(tcfg, b, 64, "cpu")
    got, tcache = tllama.llama_forward(params, tcfg, torch.from_numpy(ids),
                                       cache=tcache, cache_index=0)
    return got, ref, tcache, jcache


def test_llama_prefill_logits_and_cache_f32():
    jcfg, tcfg, tree, params = _llama("float32")
    ids = np.random.default_rng(6).integers(0, 512, (2, 19)).astype(np.int32)
    got, ref, tcache, jcache = _prefill(jcfg, tcfg, tree, params, ids)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=ATOL, rtol=0)


def test_llama_logit_index_gives_those_rows_logits_f32():
    """``logit_index`` (what a prefill samples from: each row's last prompt
    token) gives exactly those positions' rows of the full logits."""
    _jcfg, tcfg, _tree, params = _llama("float32")
    ids = torch.from_numpy(np.random.default_rng(8).integers(0, 512, (3, 11)))
    full, _ = tllama.llama_forward(params, tcfg, ids)
    index = torch.tensor([10, 0, 6])
    got, _ = tllama.llama_forward(params, tcfg, ids, logit_index=index)
    assert got.shape == (3, 1, tcfg.vocab_size)
    np.testing.assert_allclose(got[:, 0].numpy(), full[torch.arange(3), index].numpy(),
                               atol=ATOL, rtol=0)


def test_llama_scoring_path_with_padding_f32():
    jcfg, tcfg, tree, params = _llama("float32")
    ids = np.random.default_rng(7).integers(0, 512, (2, 12)).astype(np.int32)
    pad = np.ones((2, 12), bool)
    pad[1, 7:] = False
    ref, _ = jllama.llama_forward(tree, jcfg, jnp.asarray(ids), pad_mask=jnp.asarray(pad))
    got, _ = tllama.llama_forward(params, tcfg, torch.from_numpy(ids),
                                  pad_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)


def test_llama_prefill_at_per_row_offsets_f32():
    """``cache_index`` as a [B] tensor (the prior-prefix prefill): each row's
    tokens are written at its own offset into a cache already holding
    earlier KV, at positions from there, against JAX's ``llama_forward``
    with a [B] cache_index. Logits and the whole cache agree."""
    jcfg, tcfg, tree, params = _llama("float32")
    rng = np.random.default_rng(9)
    b, t, s = 3, 8, 40
    offsets = np.asarray([0, 13, 32], np.int32)
    shape = (tcfg.n_layers, b, s, tcfg.n_kv_heads, tcfg.head_dim)
    prior = {key: rng.standard_normal(shape).astype(np.float32) for key in ("k", "v")}
    ids = rng.integers(0, 512, (b, t)).astype(np.int32)
    positions = offsets[:, None] + np.arange(t, dtype=np.int32)[None, :]
    pad = np.arange(t)[None, :] < np.asarray([8, 5, 8])[:, None]
    ref, jcache = jllama.llama_forward(
        tree, jcfg, jnp.asarray(ids), positions=jnp.asarray(positions),
        cache={key: jnp.asarray(v) for key, v in prior.items()},
        cache_index=jnp.asarray(offsets), pad_mask=jnp.asarray(pad))
    got, tcache = tllama.llama_forward(
        params, tcfg, torch.from_numpy(ids), positions=torch.from_numpy(positions),
        cache={key: torch.from_numpy(v.copy()) for key, v in prior.items()},
        cache_index=torch.from_numpy(offsets), pad_mask=torch.from_numpy(pad))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
    for key in ("k", "v"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jcache[key]),
                                   atol=ATOL, rtol=0)
        # nothing outside each row's window moved
        for row, off in enumerate(offsets):
            outside = np.r_[0:off, off + t:s]
            np.testing.assert_array_equal(tcache[key].numpy()[:, row, outside],
                                          prior[key][:, row, outside])


@pytest.mark.parametrize("index", [0, 5, 36, -3])
def test_cache_write_clamps_like_dynamic_update_slice(index):
    """A start that would overhang the cache is clamped to S - T, as JAX's
    ``dynamic_update_slice`` does (an int and a per-row tensor alike)."""
    cache = torch.zeros((2, 40, 1, 1))
    kv = torch.ones((2, 8, 1, 1))
    tllama._write_cache(cache, kv, index)
    start = min(max(index, 0), 32)
    assert cache[:, start : start + 8].eq(1).all() and cache.sum() == 16
    per_row = torch.zeros((2, 40, 1, 1))
    tllama._write_cache(per_row, kv, torch.tensor([index, 3]))
    assert torch.equal(per_row[0], cache[0])
    assert per_row[1, 3:11].eq(1).all() and per_row[1].sum() == 8


def test_llama_prefill_logits_bf16():
    jcfg, tcfg, tree, params = _llama("bfloat16")
    ids = np.random.default_rng(8).integers(0, 512, (2, 19)).astype(np.int32)
    got, ref, _, _ = _prefill(jcfg, tcfg, tree, params, ids)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=0.1, rtol=0)
    agree = (got.numpy().argmax(-1) == ref.argmax(-1)).mean()
    assert agree >= 0.9, f"greedy tokens agree on only {agree:.2%} of positions"


def test_encoder_checkpoint_loads_without_jax_and_embeds_alike():
    """artifacts/encoder-ck through the port's own reader: embeddings of the
    eval bundle's texts agree with the JAX embedder's (cosine >= 0.9999)."""
    from sentio_tpu.config import EmbedderConfig as JaxEmbedderConfig
    from sentio_tpu.eval.dataset import build_bundle
    from sentio_tpu.ops.embedder import TpuEmbedder
    from sentio_tpu_torch.config import EmbedderConfig
    from sentio_tpu_torch.ops.embedder import TorchEmbedder

    ck = "artifacts/encoder-ck"
    tree, meta = weights.load_pytree(ck)
    assert meta["family"] == "encoder"
    port = TorchEmbedder(EmbedderConfig(checkpoint_path=ck), device="cpu")
    ref = TpuEmbedder(JaxEmbedderConfig(checkpoint_path=ck, coalesce=False))
    assert port.model_config.dim == ref.model_config.dim == meta["config"]["dim"]
    bundle = build_bundle(n_docs=24, n_queries=8, seed=0)
    texts = [d.text for d in bundle.documents] + [q for q, _ in bundle.queries]
    a = port.embed_many(texts)
    b = ref.embed_many(texts)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() >= 0.9999, f"min cosine {cos.min()}"
