"""``sentio_tpu_torch/eval/train_encoder.py`` against
``sentio_tpu/eval/train_encoder.py`` on the same inputs.

* The learning rate of each step equals optax's
  ``warmup_cosine_decay_schedule`` value exactly (step 0 at 0).
* Three steps of training on the tiny encoder in float32 compute from
  JAX's init carried across: the loss of each step within 1e-4 of JAX's,
  the masters within 1e-4 — but for each layer's key bias, whose exact
  gradient is 0 (adding one vector to every key shifts all of a query's
  logits alike): there float noise is all Adam sees, and it normalizes it
  into steps of up to ~lr, so those leaves are held within 2·Σlr.
* A checkpoint the port saves loads in JAX's ``load_model``; JAX's
  ``eval_recall`` on it equals the port's; ``EMBEDDER_CHECKPOINT`` serves
  it through ``build_pipeline``; bf16 leaves round-trip bit for bit.
* ``python -m sentio_tpu_torch train-encoder`` prints JAX's keys."""

import dataclasses
import json

import jax
import numpy as np
import optax
import pytest
import torch

from sentio_tpu.eval import train_encoder as jtrain
from sentio_tpu.models.transformer import EncoderConfig as JEncoderConfig
from sentio_tpu.models.transformer import init_encoder as jinit_encoder
from sentio_tpu.runtime.weights import load_model as jload_model
from sentio_tpu_torch import __main__ as cli
from sentio_tpu_torch.config import EmbedderConfig, GeneratorConfig, Settings
from sentio_tpu_torch.eval import train_encoder as ttrain
from sentio_tpu_torch.models.transformer import EncoderConfig, init_encoder
from sentio_tpu_torch.pipeline import build_pipeline
from sentio_tpu_torch.runtime import weights

LOSS_ATOL = PARAM_ATOL = 1e-4
# a small training run: one bundle, windows inside the tiny encoder's 128
# positions, warmup 1 so steps 1 and 2 move the weights
SMALL = dict(steps=3, batch=8, warmup=1, d_len=128, n_docs=32, n_queries=16, seeds=(7,))


@pytest.mark.parametrize("steps,warmup,lr", [(600, 50, 3e-4), (3, 1, 3e-4), (20, 50, 3e-4),
                                             (120, 50, 1e-3), (1, 1, 3e-4)])
def test_lr_sequence_equals_optax(steps, warmup, lr):
    tc = ttrain.TrainConfig(steps=steps, warmup=warmup, lr=lr)
    schedule = optax.warmup_cosine_decay_schedule(0.0, lr, warmup, max(steps, warmup + 1))
    assert [ttrain.lr_at(i, tc) for i in range(steps)] == \
        [float(schedule(i)) for i in range(steps)]
    assert ttrain.lr_at(0, tc) == 0.0


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        elif isinstance(value, torch.Tensor):
            out[prefix + key] = weights._to_numpy(value)  # bf16 as its uint16 bits
        else:
            out[prefix + key] = np.asarray(value)
    return out


@pytest.fixture(scope="module")
def trained(monkeypatch_module):
    """Both trainers, 3 steps, float32 compute, JAX's init; losses logged
    every step unrounded (both modules round to 4 places for the log)."""
    jcfg = dataclasses.replace(JEncoderConfig.tiny(), dtype="float32")
    tcfg = EncoderConfig(**dataclasses.asdict(jcfg))
    for module in (jtrain, ttrain):
        monkeypatch_module.setattr(module, "round", lambda x, n=None: x, raising=False)
    jparams, _cfg, jhist = jtrain.train_encoder(enc_cfg=jcfg,
                                                train_cfg=jtrain.TrainConfig(**SMALL),
                                                seed=0, log_every=1)
    init = jax.tree.map(np.asarray, jinit_encoder(jax.random.PRNGKey(0), jcfg))
    tparams, _cfg, thist = ttrain.train_encoder(
        enc_cfg=tcfg, train_cfg=ttrain.TrainConfig(**SMALL), seed=0, log_every=1,
        device="cpu", params=weights.encoder_from_jax(init))
    return dict(jparams=jax.tree.map(np.asarray, jparams), jhist=jhist, tparams=tparams,
                thist=thist, tcfg=tcfg)


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_losses_match_jax_each_step(trained):
    jl, tl = trained["jhist"]["loss"], trained["thist"]["loss"]
    assert [i for i, _ in tl] == [i for i, _ in jl] == [0, 1, 2]
    for (_i, a), (_j, b) in zip(tl, jl):
        assert abs(a - b) <= LOSS_ATOL, (tl, jl)
    assert set(trained["thist"]) - {"step_ms"} == set(trained["jhist"])
    assert trained["thist"]["pairs"] == trained["jhist"]["pairs"]


def test_params_match_jax_after_three_steps(trained):
    got = _flat(weights.encoder_to_jax(trained["tparams"]))
    ref = _flat(trained["jparams"])
    assert got.keys() == ref.keys()
    lrs = [ttrain.lr_at(i, ttrain.TrainConfig(**SMALL)) for i in range(SMALL["steps"])]
    for key in ref:
        assert got[key].dtype == np.float32, key
        err = float(np.abs(got[key] - ref[key]).max())
        bound = 2 * sum(lrs) if key.endswith("attn/wk/bias") else PARAM_ATOL
        assert err <= bound, (key, err, bound)
    moved = [k for k in ref if not np.array_equal(got[k], _flat(
        jax.tree.map(np.asarray, jinit_encoder(jax.random.PRNGKey(0), dataclasses.replace(
            JEncoderConfig.tiny(), dtype="float32"))))[k])]
    assert len(moved) > len(ref) // 2


def test_masters_must_be_float32():
    cfg = EncoderConfig.tiny()
    params = init_encoder(cfg, torch.Generator().manual_seed(0), "cpu")  # bf16 tables
    with pytest.raises(ValueError, match="float32"):
        ttrain.train_encoder(enc_cfg=cfg, train_cfg=ttrain.TrainConfig(**SMALL), device="cpu",
                             params=params)


@pytest.fixture(scope="module")
def checkpoint(trained, tmp_path_factory):
    path = tmp_path_factory.mktemp("encoder") / "ck"
    cfg = trained["tcfg"]
    weights.save_pytree(path, weights.encoder_to_jax(trained["tparams"]),
                        meta={"family": "encoder", "config": dataclasses.asdict(cfg)})
    return path


def test_checkpoint_loads_in_jax_and_recalls_alike(trained, checkpoint):
    params, cfg, tokenizer = jload_model(str(checkpoint), expect_family="encoder")
    assert tokenizer is None and cfg.dim == trained["tcfg"].dim
    ref = _flat(params)
    for key, value in _flat(weights.encoder_to_jax(trained["tparams"])).items():
        np.testing.assert_array_equal(np.asarray(ref[key]), value)
    kwargs = dict(n_docs=48, n_queries=8)
    assert ttrain.eval_recall(trained["tparams"], trained["tcfg"], device="cpu", **kwargs) == \
        jtrain.eval_recall(params, cfg, **kwargs)


def test_embedder_checkpoint_serves_the_trained_encoder(trained, checkpoint):
    settings = Settings(embedder=EmbedderConfig(checkpoint_path=str(checkpoint)),
                        generator=GeneratorConfig(model_preset="tiny", kv_page_size=16,
                                                  kv_max_pages_per_seq=64))
    pipeline = build_pipeline(settings, device="cpu")
    try:
        assert pipeline.embedder.model_config == trained["tcfg"]
        got = _flat(weights.encoder_to_jax(pipeline.embedder.params))
        for key, value in _flat(weights.encoder_to_jax(trained["tparams"])).items():
            np.testing.assert_array_equal(got[key], value)
    finally:
        pipeline.close()


def test_bf16_leaves_round_trip(tmp_path):
    cfg = EncoderConfig.tiny()
    params = init_encoder(cfg, torch.Generator().manual_seed(3), "cpu")
    weights.save_pytree(tmp_path / "ck", weights.encoder_to_jax(params),
                        meta={"family": "encoder", "config": dataclasses.asdict(cfg)})
    loaded, loaded_cfg = weights.load_model(tmp_path / "ck", expect_family="encoder")
    assert loaded_cfg == cfg
    for key, value in _flat(weights.encoder_to_jax(params)).items():
        other = _flat(weights.encoder_to_jax(loaded))[key]
        assert value.dtype == other.dtype
        assert np.array_equal(value.view(np.uint8), other.view(np.uint8)), key
    jparams, _jcfg, _tok = jload_model(str(tmp_path / "ck"), expect_family="encoder")
    kernel = jparams["layers_0"]["attn"]["wq"]["kernel"]
    assert str(kernel.dtype) == "bfloat16"
    assert np.array_equal(np.asarray(kernel).view(np.uint16),
                          _flat(weights.encoder_to_jax(params))["layers_0/attn/wq/kernel"])


def test_cli_train_encoder_prints_jax_keys(tmp_path, capsys):
    out = tmp_path / "ck"
    assert cli.main(["train-encoder", str(out), "--steps", "2", "--batch", "8", "--dim", "64",
                     "--layers", "1", "--device", "cpu"]) == 0
    payload = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(payload) == {"checkpoint", "history"}
    assert set(payload["history"]) == {"loss", "steps", "pairs", "wall_s"}
    assert payload["history"]["steps"] == 2
    _params, cfg = weights.load_model(out, expect_family="encoder")
    assert (cfg.dim, cfg.n_layers, cfg.n_heads, cfg.mlp_dim) == (64, 1, 2, 256)
