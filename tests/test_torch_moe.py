"""The port's Mixture-of-Experts decoder (``models/moe.py``) and its serving
seams against the JAX package's, on weights made by JAX's ``init_moe`` and
carried across by ``runtime/weights.py::moe_from_jax``.

Routing is compared exactly: the dispatch masks (which token takes which
slot of which expert, drops included) must be equal before any value is
compared. Tolerances: float32 values within atol 1e-4 (combine weights
1e-6: the same softmax summed in another order). In bfloat16 both sides
round every product and activation to 8 mantissa bits at slightly
different places, so logits are held at atol 0.1 (as
tests/test_torch_models.py holds Llama's), the layer output at 0.05 and
the whole model's aux loss at 1e-3; the router's masks are compared on
its float32 logits of the same bf16 input. Engines run at float32 and their greedy tokens must equal
JAX's, at the tiny config's capacity factor of 1.25 (drops included: the
two ports batch their calls alike) and at the no-drop 4.0 where
speculation and cross-engine equality need it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sentio_tpu.config import GeneratorConfig as JGeneratorConfig
from sentio_tpu.models import moe as jmoe
from sentio_tpu.models.llama import LlamaConfig as JLlamaConfig
from sentio_tpu.models.llama import init_llama as jinit_llama
from sentio_tpu.models.llama import llama_forward as jllama_forward
from sentio_tpu.runtime import paged as jpaged
from sentio_tpu.runtime.checkpoint import save_pytree
from sentio_tpu.runtime.engine import GeneratorEngine as JEngine
from sentio_tpu.runtime.paged import ContinuousBatchingEngine as JPaged
from sentio_tpu.runtime.service import PagedGenerationService as JService
from sentio_tpu.runtime.speculative import SpeculativeDecoder as JDecoder
from sentio_tpu.runtime.speculative import SpeculativeError as JSpeculativeError
from sentio_tpu.runtime.weights import load_model as jload_model
from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.models import moe
from sentio_tpu_torch.models.llama import LlamaConfig, llama_forward
from sentio_tpu_torch.models.moe import MoeConfig, moe_serving_forward
from sentio_tpu_torch.runtime import paged, weights, worker
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder, SpeculativeError
from _sanitize import _sanitized  # noqa: F401  (arms the module)


GEN = dict(model_preset="tiny", max_new_tokens=16, dtype="float32")
# windows of 256 tokens: no prompt is cut, no spec row meets the window
ENGINE_KW = dict(max_slots=4, page_size=16, max_pages_per_seq=16)
PROMPTS = ["routed experts on pages", "second request here", "a",
           "a much longer prompt that spans several pages of the cache " * 2]
NEW = 12


def _jcfg(cf=None, dtype="float32"):
    cfg = dataclasses.replace(jmoe.MoeConfig.tiny(), dtype=dtype)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def _port_cfg(jcfg):
    return MoeConfig(**dataclasses.asdict(jcfg))


def _tree(jcfg, key=3):
    return jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(key), jcfg))


@pytest.fixture(scope="module")
def tree():
    return _tree(_jcfg())


@pytest.fixture(params=[256, 0], ids=["capacity_buffers", "grouped_rows"])
def dispatch_route(request, monkeypatch):
    """Both of the port's dispatch routes: every call through the capacity
    buffers, or every call through the grouped rows."""
    monkeypatch.setattr(moe, "CAPACITY_DISPATCH_ROWS", request.param)
    return request.param


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("capacity", [3, 12, 40], ids=["drops", "few_drops", "no_drops"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_valid", "valid_mask"])
def test_route_topk_matches_jax(capacity, masked):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((40, 4)).astype(np.float32)
    valid = rng.random(40) > 0.25 if masked else None
    want = jmoe.route_topk(jnp.asarray(logits), 2, capacity,
                           None if valid is None else jnp.asarray(valid))
    got = moe.route_topk(torch.from_numpy(logits), 2, capacity,
                         None if valid is None else torch.from_numpy(valid))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6, rtol=0)
    if capacity == 3:
        assert int(np.asarray(want[0]).sum()) < 2 * (40 if valid is None else valid.sum())


def test_capacity_counts_every_token_of_the_call():
    """C = ceil(G·k/E · cf) over every row × token, padding included."""
    for g in (1, 8, 40, 3400):
        for cf in (1.25, 4.0):
            jcfg = _jcfg(cf)
            assert moe.expert_capacity(_port_cfg(jcfg), g) == jmoe.expert_capacity(jcfg, g)
    # Mixtral's 8 experts, top-2, at the no-drop cf 4: C = G
    mixtral = dataclasses.replace(_port_cfg(_jcfg(4.0)), n_experts=8)
    assert moe.expert_capacity(mixtral, 3400) == 3400


# ------------------------------------------------------------------ layers


def _router_masks(mp_j, jcfg, x, pad):
    """JAX's dispatch mask for ``x`` through the router, by JAX's route."""
    flat = x.reshape(-1, x.shape[-1])
    logits = flat.astype(jnp.float32) @ jnp.asarray(mp_j["router"]["kernel"], jnp.float32)
    cap = jmoe.expert_capacity(jcfg, flat.shape[0])
    return np.asarray(jmoe.route_topk(logits, jcfg.experts_per_token, cap,
                                      None if pad is None else pad.reshape(-1))[0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_mlp_matches_jax(dtype, dispatch_route):
    jcfg = _jcfg(dtype=dtype)
    tree = _tree(jcfg)
    cfg = _port_cfg(jcfg)
    params = weights.moe_from_jax(tree)  # float32 masters cast at use, as JAX's
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20, jcfg.dim)).astype(np.float32)
    pad = np.ones((3, 20), bool)
    pad[1, 12:] = False
    pad[2, 3:] = False
    jx = jnp.asarray(x, jcfg.jdtype)
    want, want_aux = jmoe.moe_mlp(tree["layers_0"]["moe"], jcfg, jx, jnp.asarray(pad))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(cfg.torch_dtype)
    # the masks first: the port's routing of the same router logits
    flat = tx.reshape(-1, jcfg.dim)
    logits = torch.nn.functional.linear(flat.float(),
                                        params["layers_0"]["moe"]["router"]["weight"].float())
    cap = moe.expert_capacity(cfg, flat.shape[0])
    got_mask = moe.route_topk(logits, cfg.experts_per_token, cap,
                              torch.from_numpy(pad).reshape(-1))[0]
    np.testing.assert_array_equal(got_mask.numpy(),
                                  _router_masks(tree["layers_0"]["moe"], jcfg, jx,
                                                jnp.asarray(pad)))
    got, got_aux = moe.moe_mlp(params["layers_0"]["moe"], cfg, tx, torch.from_numpy(pad))
    atol = 1e-4 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol,
                               rtol=0)
    np.testing.assert_allclose(float(got_aux), float(want_aux), atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_cache", [False, True], ids=["training", "prefill_cache"])
def test_moe_forward_matches_jax(dtype, with_cache, dispatch_route):
    """Logits, the prefill cache and the summed aux loss, with padding."""
    jcfg = _jcfg(dtype=dtype)
    tree = _tree(jcfg)
    cfg = _port_cfg(jcfg)
    params = weights.moe_from_jax(tree)  # float32 masters cast at use, as JAX's
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 500, (3, 40)).astype(np.int32)
    pad = np.ones((3, 40), bool)
    pad[1, 30:] = False
    pad[2, 5:] = False
    jcache = tcache = None
    if with_cache:
        from sentio_tpu.models.llama import init_cache as jinit_cache

        from sentio_tpu_torch.models.llama import init_cache

        jcache, tcache = jinit_cache(jcfg, 3, 64), init_cache(cfg, 3, 64, "cpu")
    want, want_cache, want_aux = jmoe.moe_forward(tree, jcfg, jnp.asarray(ids), cache=jcache,
                                                  pad_mask=jnp.asarray(pad))
    got, got_cache, got_aux = moe.moe_forward(params, cfg, torch.from_numpy(ids).long(),
                                              cache=tcache, pad_mask=torch.from_numpy(pad))
    atol = 1e-4 if dtype == "float32" else 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol, rtol=0)
    # bf16: the routers read hidden states rounded at other places
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               atol=1e-4 if dtype == "float32" else 1e-3, rtol=0)
    if with_cache:
        for name in ("k", "v"):
            np.testing.assert_allclose(got_cache[name].float().numpy(),
                                       np.asarray(want_cache[name], np.float32),
                                       atol=atol, rtol=0)
    # the serving form: the same logits, last rows only through logit_index
    last = torch.tensor([39, 29, 4])
    tail, _ = moe_serving_forward(params, cfg, torch.from_numpy(ids).long(),
                                  pad_mask=torch.from_numpy(pad), logit_index=last)
    np.testing.assert_allclose(tail[:, 0].numpy(), got[torch.arange(3), last].numpy(),
                               atol=1e-5 if dtype == "float32" else 0.1, rtol=0)


def test_both_dispatch_routes_compute_one_function(tree, monkeypatch):
    """Grouped rows and capacity buffers give the same logits and cache."""
    cfg = _port_cfg(_jcfg())
    params = weights.moe_from_jax(tree)
    ids = torch.from_numpy(np.random.default_rng(9).integers(0, 500, (4, 50))).long()
    outs = []
    for rows in (0, 10_000):
        monkeypatch.setattr(moe, "CAPACITY_DISPATCH_ROWS", rows)
        outs.append(moe.moe_forward(params, cfg, ids)[0])
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), atol=1e-5, rtol=0)


def test_weights_keep_expert_stacks_and_round_trip(tree):
    params = weights.moe_from_jax(tree, dtype=torch.bfloat16)
    mp = params["layers_1"]["moe"]
    assert tuple(mp["w_gate"].shape) == tree["layers_1"]["moe"]["w_gate"].shape  # [E, in, out]
    assert mp["w_down"].dtype == torch.bfloat16
    np.testing.assert_array_equal(mp["router"]["weight"].float().numpy(),
                                  tree["layers_1"]["moe"]["router"]["kernel"].T.astype(
                                      np.float32).astype(jnp.bfloat16).astype(np.float32))
    back = weights.decoder_to_jax(weights.moe_from_jax(tree))
    for path in (("layers_0", "moe", "w_up"), ("layers_0", "moe", "router", "kernel"),
                 ("layers_1", "attn", "wq", "kernel"), ("embed_tokens", "embedding")):
        a, b = back, tree
        for key in path:
            a, b = a[key], b[key]
        np.testing.assert_array_equal(a.numpy(), b)
    with pytest.raises(ValueError, match="not a moe parameter tree"):
        weights.moe_from_jax(jax.tree.map(np.asarray, jinit_llama(
            jax.random.PRNGKey(0), dataclasses.replace(JLlamaConfig.tiny(), dtype="float32"))))


def test_paged_decode_sub_step_routes_with_the_write_mask(tree, dispatch_route):
    """One paged decode sub-step over the same pool: the moe branch, with
    frozen rows masked out of routing and their writes sent to scratch."""
    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    params = weights.moe_from_jax(tree)
    rng = np.random.default_rng(5)
    shape = (jcfg.n_layers, 9, 16, jcfg.n_kv_heads, jcfg.head_dim)
    k_pages = rng.standard_normal(shape).astype(np.float32)
    v_pages = rng.standard_normal(shape).astype(np.float32)
    table = np.array([[1, 2, 0, 0], [3, 4, 5, 0], [6, 0, 0, 0], [7, 8, 0, 0]], np.int32)
    lens = np.array([20, 40, 3, 31], np.int32)
    tok = np.array([5, 300, 17, 42], np.int32)
    write_mask = np.array([True, False, True, True])
    want, jk, _jv = jpaged.paged_decode_forward(
        tree, jcfg, jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(table),
        jnp.asarray(k_pages), jnp.asarray(v_pages), write_mask=jnp.asarray(write_mask))
    tk, tv = torch.from_numpy(k_pages.copy()), torch.from_numpy(v_pages.copy())
    got = paged.paged_decode_forward(params, cfg, torch.from_numpy(tok).long(),
                                     torch.from_numpy(lens), torch.from_numpy(table), tk, tv,
                                     write_mask=torch.from_numpy(write_mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-5, rtol=0)


# ----------------------------------------------------------------- engines


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_paged_engine_greedy_tokens_match_jax(cf):
    jcfg = _jcfg(cf)
    tree = _tree(jcfg, key=0)
    ref = JPaged(model_config=jcfg, params=tree, use_pallas=True, **ENGINE_KW)
    port = ContinuousBatchingEngine(model_config=_port_cfg(jcfg),
                                    params=weights.moe_from_jax(tree), device="cpu",
                                    **ENGINE_KW)
    assert port.forward_fn is moe_serving_forward
    want = ref.run_all(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    got = port.run_all(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    np.testing.assert_allclose([r.logprob_sum for r in got], [r.logprob_sum for r in want],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_contiguous_engine_greedy_tokens_match_jax(cf):
    jcfg = _jcfg(cf)
    tree = _tree(jcfg, key=0)
    ref = JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, params=tree,
                  forward_fn=jmoe.moe_serving_forward)
    port = GeneratorEngine(config=GeneratorConfig(**GEN), model_config=_port_cfg(jcfg),
                           params=weights.moe_from_jax(tree), device="cpu")
    assert port.forward_fn is moe_serving_forward
    want = ref.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    got = port.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == [r.finish_reason for r in want]
    streamed = "".join(port.stream(PROMPTS[0], max_new_tokens=NEW, temperature=0.0))
    assert streamed == "".join(ref.stream(PROMPTS[0], max_new_tokens=NEW, temperature=0.0))


def test_engines_agree_at_the_no_drop_capacity():
    """Paged (graphless sub-steps, prefix cache) and contiguous engines give
    the same greedy tokens once no token can drop."""
    jcfg = _jcfg(4.0)
    tree = _tree(jcfg, key=0)
    params = weights.moe_from_jax(tree)
    pagedg = ContinuousBatchingEngine(model_config=_port_cfg(jcfg), params=params,
                                      device="cpu", **ENGINE_KW)
    contig = GeneratorEngine(config=GeneratorConfig(**GEN), model_config=_port_cfg(jcfg),
                             params=params, device="cpu")
    a = pagedg.run_all(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    b = contig.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in a] == [r.tokens for r in b]


def test_moe_config_alone_selects_the_family():
    """A MoeConfig with no params random-inits MoE weights and routes."""
    cfg = MoeConfig.tiny()
    eng = ContinuousBatchingEngine(model_config=cfg, max_slots=2, page_size=16,
                                   max_pages_per_seq=4, device="cpu")
    assert eng.forward_fn is moe_serving_forward and "moe" in eng.params["layers_0"]
    contig = GeneratorEngine(config=GeneratorConfig(model_preset="tiny"), model_config=cfg,
                             device="cpu")
    assert contig.forward_fn is moe_serving_forward
    assert contig.params["layers_1"]["moe"]["w_gate"].shape == (4, 64, 128)
    assert eng.run_all(["hello experts"], max_new_tokens=4)[0].tokens
    # the engine's routing tally counted its calls, padding apart from drops
    stats = eng.stats()
    assert len(stats["moe_routed"]) == cfg.n_experts and sum(stats["moe_routed"]) > 0
    assert stats["moe_dropped"] >= 0 and stats["moe_padding"] > 0


def test_routing_tally_is_the_engines_own():
    """Each MoE engine counts its own routing in its stats: another engine
    on the same weights and a forward call outside the engine add nothing
    to it; a llama engine reports none."""
    cfg = MoeConfig.tiny()
    kw = dict(max_slots=2, page_size=16, max_pages_per_seq=4, device="cpu")
    a = ContinuousBatchingEngine(model_config=cfg, **kw)
    b = ContinuousBatchingEngine(model_config=cfg, params=a.params, **kw)
    assert a.run_all(["hello experts"], max_new_tokens=4)[0].tokens
    moe_serving_forward(a.params, cfg, torch.tensor([[1, 2, 3]]))
    got, untouched = a.stats(), b.stats()
    # every routed row × token counts k choices: routed, dropped or padding
    total = sum(got["moe_routed"]) + got["moe_dropped"] + got["moe_padding"]
    assert total > 0 and total % cfg.experts_per_token == 0
    assert (sum(untouched["moe_routed"]), untouched["moe_dropped"],
            untouched["moe_padding"]) == (0, 0, 0)
    assert "moe_routed" not in ContinuousBatchingEngine(model_config=LlamaConfig.tiny(),
                                                        **kw).stats()


@pytest.mark.parametrize("case", ["moe_fn_dense_cfg", "dense_fn_moe_cfg", "custom_fn"])
def test_family_mismatch_raises_the_jax_error(case):
    from sentio_tpu.models.llama import LlamaConfig as JDense

    def custom(*a, **k):
        return None

    jcfg, jfn, cfg, fn = {
        "moe_fn_dense_cfg": (JDense.tiny(), jmoe.moe_serving_forward, LlamaConfig.tiny(),
                             moe_serving_forward),
        "dense_fn_moe_cfg": (jmoe.MoeConfig.tiny(), jllama_forward, MoeConfig.tiny(),
                             llama_forward),
        "custom_fn": (jmoe.MoeConfig.tiny(), custom, MoeConfig.tiny(), custom),
    }[case]
    with pytest.raises(ValueError) as want:
        JPaged(model_config=jcfg, forward_fn=jfn, max_slots=2, page_size=16,
               max_pages_per_seq=4)
    with pytest.raises(ValueError) as got:
        ContinuousBatchingEngine(model_config=cfg, forward_fn=fn, max_slots=2, page_size=16,
                                 max_pages_per_seq=4, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, forward_fn=jfn)
    with pytest.raises(ValueError) as got:
        GeneratorEngine(config=GeneratorConfig(**GEN), model_config=cfg, forward_fn=fn,
                        device="cpu")
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- speculation


def _draft_llama():
    dcfg = dataclasses.replace(
        JLlamaConfig(vocab_size=512, dim=32, n_layers=1, n_heads=2, n_kv_heads=2, mlp_dim=64,
                     max_len=512), dtype="float32")
    dtree = jax.tree.map(np.asarray, jinit_llama(jax.random.PRNGKey(7), dcfg))
    return weights.llama_from_jax(dtree), LlamaConfig(**dataclasses.asdict(dcfg))


@pytest.mark.parametrize("depth", [1, 2])
def test_paged_spec_with_a_llama_draft_is_exact(depth):
    jcfg = _jcfg(4.0)
    tree = _tree(jcfg, key=0)
    params = weights.moe_from_jax(tree)
    dparams, dcfg = _draft_llama()
    kw = {**ENGINE_KW, "pipeline_depth": depth}
    plain = ContinuousBatchingEngine(model_config=_port_cfg(jcfg), params=params,
                                     device="cpu", **kw)
    spec = ContinuousBatchingEngine(model_config=_port_cfg(jcfg), params=params,
                                    draft_params=dparams, draft_config=dcfg, spec_k=3,
                                    device="cpu", **kw)
    want = plain.run_all(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    got = spec.run_all(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert spec.spec_verifies_total > 0
    ref = JPaged(model_config=jcfg, params=tree, use_pallas=True,
                 draft_params=jax.tree.map(np.asarray, jinit_llama(
                     jax.random.PRNGKey(7), dataclasses.replace(JLlamaConfig(
                         vocab_size=512, dim=32, n_layers=1, n_heads=2, n_kv_heads=2,
                         mlp_dim=64, max_len=512), dtype="float32"))),
                 draft_config=dataclasses.replace(JLlamaConfig(
                     vocab_size=512, dim=32, n_layers=1, n_heads=2, n_kv_heads=2, mlp_dim=64,
                     max_len=512), dtype="float32"), spec_k=3, **kw)
    jwant = ref.run_all(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in jwant]
    assert spec.spec_verifies_total == ref.spec_verifies_total


def test_paged_engine_refuses_a_moe_draft():
    cfg = _port_cfg(_jcfg(4.0))
    with pytest.raises(ValueError, match="llama model"):
        ContinuousBatchingEngine(model_config=cfg, draft_params={}, draft_config=cfg,
                                 device="cpu", **ENGINE_KW)


@pytest.mark.parametrize("draft", ["moe", "llama"])
def test_contiguous_spec_is_exact(draft):
    """A MoE target with a MoE draft (another seed, two experts of four
    active) or a llama draft: tokens equal plain decoding and JAX's."""
    jcfg = _jcfg(4.0)
    tree = _tree(jcfg, key=0)
    ref = JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, params=tree)
    port = GeneratorEngine(config=GeneratorConfig(**GEN), model_config=_port_cfg(jcfg),
                           params=weights.moe_from_jax(tree), device="cpu")
    if draft == "moe":
        jdcfg = dataclasses.replace(_jcfg(1.25), n_layers=1)
        jdtree = _tree(jdcfg, key=8)
        dparams, dcfg = weights.moe_from_jax(jdtree), _port_cfg(jdcfg)
    else:
        dparams, dcfg = _draft_llama()
        jdcfg = dataclasses.replace(JLlamaConfig(
            vocab_size=512, dim=32, n_layers=1, n_heads=2, n_kv_heads=2, mlp_dim=64,
            max_len=512), dtype="float32")
        jdtree = jax.tree.map(np.asarray, jinit_llama(jax.random.PRNGKey(7), jdcfg))
    dec = SpeculativeDecoder(port, dparams, dcfg, k=3)
    plain = port.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    got = dec.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in plain]
    jdec = JDecoder(ref, jdtree, jdcfg, k=3)
    want = jdec.generate(PROMPTS, max_new_tokens=NEW, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert dec.stats == jdec.stats


def test_spec_capacity_error_matches_jax():
    jcfg = _jcfg(1.25)
    tree = _tree(jcfg, key=0)
    ref = JEngine(config=JGeneratorConfig(**GEN), model_config=jcfg, params=tree)
    port = GeneratorEngine(config=GeneratorConfig(**GEN), model_config=_port_cfg(jcfg),
                           params=weights.moe_from_jax(tree), device="cpu")
    dparams, dcfg = _draft_llama()
    with pytest.raises(JSpeculativeError) as want:
        JDecoder(ref, jax.tree.map(np.asarray, jinit_llama(jax.random.PRNGKey(7), dataclasses
                 .replace(JLlamaConfig(vocab_size=512, dim=32, n_layers=1, n_heads=2,
                                       n_kv_heads=2, mlp_dim=64, max_len=512),
                          dtype="float32"))), dcfg, k=3)
    with pytest.raises(SpeculativeError) as got:
        SpeculativeDecoder(port, dparams, dcfg, k=3)
    assert str(got.value) == str(want.value)


# ------------------------------------------------------- checkpoint, worker


@pytest.fixture(scope="module")
def moe_checkpoint(tmp_path_factory):
    jcfg = _jcfg(4.0)
    path = tmp_path_factory.mktemp("moe-ck") / "moe"
    save_pytree(path, _tree(jcfg, key=5), meta={"family": "moe", "config": jcfg.__dict__})
    return str(path)


def test_worker_factory_builds_the_moe_family(moe_checkpoint):
    """``default_service_factory``'s moe branch: from a checkpoint (JAX's
    ``expect_family``) and from a config alone; greedy tokens equal JAX's
    service on the same checkpoint."""
    kw = dict(engine_kwargs=dict(ENGINE_KW), device="cpu")
    svc = worker.default_service_factory(model_family="moe", checkpoint_path=moe_checkpoint,
                                         **kw)
    params, jcfg, _tok = jload_model(moe_checkpoint, expect_family="moe")
    ref = JService(JPaged(model_config=jcfg, params=params, **ENGINE_KW))
    try:
        assert isinstance(svc.engine.cfg, MoeConfig)
        for p in PROMPTS[:2]:
            assert (svc.generate(p, max_new_tokens=NEW, temperature=0.0).tokens
                    == ref.generate(p, max_new_tokens=NEW, temperature=0.0).tokens)
    finally:
        svc.close()
        ref.close()
    with pytest.raises(weights.WeightsError, match="expected 'llama'"):
        worker.default_service_factory(model_family="llama", checkpoint_path=moe_checkpoint,
                                       **kw)
    fresh = worker.default_service_factory(
        model_family="moe", model_config=dataclasses.asdict(_port_cfg(jcfg)), **kw)
    try:
        assert isinstance(fresh.engine.cfg, MoeConfig)
        assert "moe" in fresh.engine.params["layers_0"]
    finally:
        fresh.close()
    assert moe.decoder_config("moe", dataclasses.asdict(_port_cfg(jcfg))) == _port_cfg(jcfg)


def test_worker_spec_names_the_family_as_jax():
    """``worker_spec`` sets ``model_family`` from the engine's config, as
    JAX's container sets it (``"moe"`` for a ``MoeConfig``), and the
    factory rebuilds that config from the spec."""
    import dataclasses as dc

    from sentio_tpu_torch.config import Settings
    from sentio_tpu_torch.pipeline import worker_spec

    for cfg in (_port_cfg(_jcfg(4.0)), LlamaConfig.tiny()):
        kwargs = worker_spec(Settings(), cfg, 0, device="cpu").factory_kwargs
        assert kwargs["model_family"] == ("moe" if isinstance(cfg, MoeConfig) else "llama")
        assert moe.decoder_config(kwargs["model_family"], kwargs["model_config"]) == cfg
        assert kwargs["model_config"] == dc.asdict(cfg)
