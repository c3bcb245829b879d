"""The MoE decoder on an ep × tp mesh against JAX's, on the CPU:
``MOE_EP_RULES`` placement, ``moe_loss`` and its gradients on dp × ep × tp,
the ep train step, both dispatch routes under autograd, and the engines
serving the model on the mesh.

JAX runs on the 8 virtual host devices of ``tests/conftest.py``; the port
lays the same geometry over ``[cpu] * k``. Weights come from JAX's init
functions; batches from numpy seeds. Tolerances (float32): losses rtol
1e-5, gradients atol 1e-5, one AdamW step against optax atol 1e-6, the
sharded experts' outputs against one device's atol 1e-5, greedy tokens
exact.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sentio_tpu.config import MeshConfig as JMeshConfig
from sentio_tpu.models.moe import MoeConfig as JMoeConfig
from sentio_tpu.models.moe import init_moe as jax_init_moe
from sentio_tpu.models.moe import moe_loss as jax_moe_loss
from sentio_tpu.parallel import mesh as jmesh
from sentio_tpu.parallel import sharding as jsharding
from sentio_tpu_torch.config import GeneratorConfig, MeshConfig
from sentio_tpu_torch.models import moe
from sentio_tpu_torch.models.moe import MoeConfig, decoder_rules, moe_loss
from sentio_tpu_torch.parallel import collectives
from sentio_tpu_torch.parallel import mesh as pmesh
from sentio_tpu_torch.parallel import sharding as psharding
from sentio_tpu_torch.runtime.engine import GeneratorEngine
from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine
from sentio_tpu_torch.runtime.weights import decoder_to_jax, moe_from_jax

CPU = torch.device("cpu")
MOE = dict(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2, mlp_dim=128,
           max_len=512, rope_theta=10_000.0, dtype="float32", n_experts=4,
           experts_per_token=2)
ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def port_mesh(**fields):
    n = int(np.prod(list(fields.values())))
    return pmesh.build_mesh(MeshConfig(**fields), devices=[CPU] * n)


def port_tree(tree) -> dict:
    return dict(psharding.leaves(moe_from_jax(tree)))


def nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        *heads, last = path.split("/")
        node = tree
        for key in heads:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


@pytest.fixture(scope="module")
def model():
    jcfg = JMoeConfig(**MOE)
    return jcfg, MoeConfig(**MOE), np_tree(jax_init_moe(jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def reference(model):
    """JAX's ``moe_loss`` and its gradients on a padded batch."""
    jcfg, _, tree = model
    rng = np.random.default_rng(5)
    ids = rng.integers(1, MOE["vocab_size"], (4, 17))
    mask = np.ones((4, 17), bool)
    mask[1, 12:] = mask[3, 5:] = False
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jax_moe_loss(
        p, jcfg, jnp.asarray(ids), jnp.asarray(mask))))(jax.tree.map(jnp.asarray, tree))
    return dict(ids=ids, mask=mask, loss=float(loss), grads=port_tree(np_tree(grads)))


def shard(tree, **fields):
    return psharding.shard_params(moe_from_jax(tree), port_mesh(**fields),
                                  psharding.MOE_EP_RULES)


def assemble_grads(sharded, like: dict) -> dict:
    out = {path: torch.zeros_like(t) for path, t in like.items()}
    for coord, tree in sharded.trees.items():
        for path, leaf in psharding.leaves(tree):
            out[path][tuple(slice(lo, hi) for lo, hi in sharded.slices[coord][path])] = \
                leaf.grad
    return out


def assert_close(got: dict, ref: dict, atol: float) -> None:
    assert got.keys() == ref.keys()
    for path in ref:
        np.testing.assert_allclose(got[path].detach().numpy(), ref[path].detach().numpy(),
                                   atol=atol, rtol=0, err_msg=path)


# --------------------------------------------------------------- placement


def test_ep_rules_place_experts_on_ep(model):
    """JAX's ``test_ep_rules_place_experts_on_ep`` on the port's shards:
    each coordinate holds E/ep experts, each expert's product split over
    tp (the stacks keep JAX's [E, in, out] layout), the router whole; and
    ``describe_shardings`` prints JAX's specs for the tree."""
    jcfg, cfg, tree = model
    sharded = shard(tree, dp_size=2, ep_size=2, tp_size=2)
    for (dcn, dp, pp, ep, sp, tp), t in sharded.trees.items():
        mp = t["layers_0"]["moe"]
        assert sharded.slices[(dcn, dp, pp, ep, sp, tp)]["layers_0/moe/w_gate"] == (
            (2 * ep, 2 * ep + 2), (0, 64), (64 * tp, 64 * tp + 64))
        assert mp["w_down"].shape == (2, 64, 64) and mp["router"]["weight"].shape == (4, 64)
    jm = jmesh.build_mesh(JMeshConfig(dp_size=2, ep_size=2, tp_size=2))
    assert psharding.describe_shardings(moe_from_jax(tree), None, psharding.MOE_EP_RULES) == \
        jsharding.describe_shardings(tree, jm, jsharding.MOE_EP_RULES)
    assert decoder_rules(cfg) is psharding.MOE_EP_RULES


def test_stacked_moe_tree_round_trips(model):
    """JAX's stacked MoE tree crosses over with its [L, E, in, out] expert
    stacks as they are and its kernels as [L, out, in] weights, and back,
    leaf for leaf; the port's stacking of the carried tree is the same."""
    from sentio_tpu.models.llama import stack_layer_params as jax_stack
    from sentio_tpu_torch.models.llama import stack_layer_params
    from sentio_tpu_torch.runtime.weights import stacked_from_jax, stacked_to_jax

    jcfg, cfg, tree = model
    jstacked = np_tree(jax_stack(tree, jcfg))
    port = stacked_from_jax(jstacked)
    assert port["layers"]["moe"]["w_gate"].shape == (2, 4, 64, 128)
    assert port["layers"]["attn"]["wk"]["weight"].shape == (2, 32, 64)
    ours = dict(psharding.leaves(stack_layer_params(moe_from_jax(tree), cfg)))
    assert_close(dict(psharding.leaves(port)), ours, 0)
    back = jax.tree_util.tree_leaves_with_path(stacked_to_jax(port))
    ref = jax.tree_util.tree_leaves_with_path(jstacked)
    assert [p for p, _ in back] == [p for p, _ in ref]
    assert all(np.array_equal(np.asarray(a), np.asarray(b)) for (_, a), (_, b) in zip(back, ref))


# ------------------------------------------------------------ loss, grads


@pytest.mark.parametrize("fields", [dict(dp_size=2, ep_size=2, tp_size=2),
                                    dict(ep_size=4, tp_size=1), dict(ep_size=1, tp_size=2)],
                         ids=["dp2_ep2_tp2", "ep4", "tp2"])
def test_moe_loss_and_gradients_match_jax(model, reference, fields):
    """The ep × tp forward routes once from the replicated router and sums
    the experts' partial outputs over ep and tp: JAX's loss, and each
    shard's gradient the slice of JAX's it holds (the routing and the
    router aux stay in the graph)."""
    _, cfg, tree = model
    sharded = shard(tree, **fields)
    for t in sharded.parameters():
        t.requires_grad_(True)
    loss = moe_loss(sharded, cfg, torch.tensor(reference["ids"]),
                    torch.tensor(reference["mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=1e-5)
    assert_close(assemble_grads(sharded, reference["grads"]), reference["grads"], 1e-5)


@pytest.mark.parametrize("route", ["capacity", "grouped"])
def test_both_dispatch_routes_train(model, reference, monkeypatch, route):
    """Both routes are differentiable: the plain tree's loss and gradients
    are JAX's whichever route dispatches (the grouped rows forced by a
    threshold of 0)."""
    _, cfg, tree = model
    if route == "grouped":
        monkeypatch.setattr(moe, "CAPACITY_DISPATCH_ROWS", 0)
    params = moe_from_jax(tree)
    leaves = dict(psharding.leaves(params))
    for t in leaves.values():
        t.requires_grad_(True)
    loss = moe_loss(params, cfg, torch.tensor(reference["ids"]),
                    torch.tensor(reference["mask"]))
    loss.backward()
    np.testing.assert_allclose(loss.item(), reference["loss"], rtol=1e-5)
    assert_close({p: t.grad for p, t in leaves.items()}, reference["grads"], 1e-5)


@pytest.mark.parametrize("route", ["capacity", "grouped"])
def test_ep_moe_mlp_matches_one_device(model, monkeypatch, route):
    """One layer's experts over ep × tp shards against ``moe_mlp`` on
    the whole tree, at bf16 too (the tp partials add in another order)."""
    _, cfg, tree = model
    if route == "grouped":
        monkeypatch.setattr(moe, "CAPACITY_DISPATCH_ROWS", 0)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((3, 7, 64)).astype(
        np.float32))
    pad = torch.ones(3, 7, dtype=torch.bool)
    pad[2, 4:] = False
    for dtype, atol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        c = dataclasses.replace(cfg, dtype=dtype)
        params = moe_from_jax(tree)
        want, aux = moe.moe_mlp(params["layers_1"]["moe"], c, x, pad)
        shards = psharding.shard_params(params, port_mesh(ep_size=2, tp_size=2),
                                        psharding.MOE_EP_RULES).group(0)
        tally = moe.route_tally(c, CPU)
        got, got_aux = moe.ep_moe_mlp(shards, "layers_1", c, x, pad, tally)
        np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=atol,
                                   rtol=0)
        assert got_aux.item() == aux.item()
        assert moe.tally_stats(tally)["moe_padding"] == 2 * 3


def test_ep_train_step_matches_optax(model, reference):
    """``moe_loss``, backward, the copies' gradient sum and one AdamW step on
    dp × ep × tp: each shard's tensor is optax's step (on the port's
    gradients, which match JAX's) of the slice it holds."""
    _, cfg, tree = model
    sharded = shard(tree, dp_size=2, ep_size=2, tp_size=2)
    tensors = sharded.parameters()
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(tensors, **ADAMW)
    loss = moe_loss(sharded, cfg, torch.tensor(reference["ids"]),
                    torch.tensor(reference["mask"]))
    loss.backward()
    collectives.psum_replicated_grads(sharded.copies())
    grads = assemble_grads(sharded, reference["grads"])
    opt.step()
    assert np.isfinite(loss.item())
    params = jax.tree.map(jnp.asarray, tree)
    g = jax.tree.map(jnp.asarray, np_tree(decoder_to_jax(nest(
        {k: v.detach() for k, v in grads.items()}))))
    tx = optax.adamw(1e-3)
    updates, _ = tx.update(g, tx.init(params), params)
    want = port_tree(np_tree(optax.apply_updates(params, updates)))
    for coord, t in sharded.trees.items():
        for path, leaf in psharding.leaves(t):
            index = tuple(slice(lo, hi) for lo, hi in sharded.slices[coord][path])
            np.testing.assert_allclose(leaf.detach().numpy(), want[path][index].numpy(),
                                       atol=1e-6, rtol=0, err_msg=path)
    before = port_tree(tree)
    moved = [path for path, leaf in psharding.leaves(sharded.trees[(0,) * 6])
             if not torch.equal(leaf.detach(), before[path][tuple(
                 slice(lo, hi) for lo, hi in sharded.slices[(0,) * 6][path])])]
    assert "layers_0/moe/w_gate" in moved and "layers_1/moe/router/weight" in moved


# ---------------------------------------------------------------- serving


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_engine_on_an_ep_tp_mesh(model, kv_quant):
    """JAX's ``test_paged_serving_on_ep_mesh``: dp 2 × ep 2 × tp 2, the
    default family path (``MOE_EP_RULES``), the pool's kv heads on tp,
    greedy tokens equal to the single-device engine's; the routing tally
    counts what one device's does."""
    jcfg, cfg, tree = model
    acfg = dataclasses.replace(cfg, capacity_factor=8.0)
    geometry = dict(max_slots=4, page_size=16, max_pages_per_seq=8, steps_per_tick=4,
                    kv_quant=kv_quant, device="cpu")
    prompts = ["experts on a mesh", "second lane"]
    mesh = port_mesh(dp_size=2, ep_size=2, tp_size=2)
    served = ContinuousBatchingEngine(model_config=acfg, params=moe_from_jax(tree), mesh=mesh,
                                      **geometry)
    got = served.run_all(prompts, max_new_tokens=8)
    single = ContinuousBatchingEngine(model_config=acfg, params=moe_from_jax(tree), **geometry)
    want = single.run_all(prompts, max_new_tokens=8)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert served.tp == 2 and len(served.params.experts) == 2
    assert served.sharded.rules is psharding.MOE_EP_RULES
    assert served.stats()["moe_routed"] == single.stats()["moe_routed"]


def test_contiguous_engine_on_an_ep_tp_mesh(model):
    _, cfg, tree = model
    gen = GeneratorConfig(model_preset="tiny", max_new_tokens=8)
    prompts = ["routed experts", "over a mesh", "x"]
    got = GeneratorEngine(gen, model_config=cfg, params=moe_from_jax(tree),
                          mesh=port_mesh(ep_size=2, tp_size=2)).generate(prompts,
                                                                         temperature=0.0)
    want = GeneratorEngine(gen, model_config=cfg, params=moe_from_jax(tree),
                           device="cpu").generate(prompts, temperature=0.0)
    assert [r.tokens for r in got] == [r.tokens for r in want]
