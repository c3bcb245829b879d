"""In-tree contrastive training of the bi-encoder — ``sentio_tpu/eval/
train_encoder.py`` in PyTorch.

Dense retrieval needs trained weights, and nothing is downloaded: the
encoder trains on bundle-shaped data (:mod:`.dataset`) drawn from other
seeds than the eval bundle (seed 0), so it must learn the task — match
subject / component mentions across paraphrase templates — not the eval
corpus. Objective: symmetric InfoNCE with in-batch negatives over
mean-pooled, L2-normalized embeddings, the serving path's embedding.

Each step runs two encoder forwards (queries, documents) and a ``[B, B]``
logit matrix under autograd, then ``torch.optim.AdamW``. As in JAX:

* the master weights are float32 leaves (``init_encoder(...,
  dtype=torch.float32)``) and the forward computes in the config's dtype
  (``layers.dense`` casts at use), the loss in float32;
* weight decay 0.01 on every leaf (optax's unmasked ``adamw``), and the
  learning rate of step ``i`` is :func:`lr_at` ``(i)`` — optax's
  ``warmup_cosine_decay_schedule(0, lr, warmup, steps)`` evaluated at the
  update count before its increment, so step 0 has lr 0;
* the forward is ``encoder_forward(..., attn_fn=None)``: plain attention
  under autograd (the flash kernel has no backward and its wrapper
  refuses to run where a gradient is wanted);
* batches come from the same numpy permutations, so the batches equal
  JAX's for a seed.

:func:`train_encoder` saves a ``save_pytree`` checkpoint (family
``encoder``) that JAX's ``load_model``, ``EMBEDDER_CHECKPOINT`` and ``eval
--encoder-checkpoint`` load; :func:`eval_recall` measures recall@10 on the
eval bundle through the serving embedder and dense index (on the card,
the flash kernel).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
import logging
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.eval.dataset import build_bundle
from sentio_tpu_torch.models.transformer import EncoderConfig

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class TrainConfig:
    steps: int = 600
    batch: int = 64
    lr: float = 3e-4
    tau: float = 0.05          # InfoNCE temperature
    q_len: int = 64            # queries are short questions
    d_len: int = 160           # facts are ~110-130 chars (byte tokenizer)
    n_docs: int = 1024         # per training bundle
    n_queries: int = 4096      # per training bundle
    seeds: tuple = (7, 11, 13)  # training bundles; eval uses seed 0
    warmup: int = 50


def lr_at(step: int, tc: TrainConfig) -> float:
    """optax's ``warmup_cosine_decay_schedule(0.0, tc.lr, tc.warmup,
    max(tc.steps, tc.warmup + 1))`` at ``step``, with optax's float32
    operations in optax's order: linear from 0 to the peak over the warmup,
    then a cosine to 0 over the remaining steps."""
    f32 = np.float32
    warmup, decay = tc.warmup, max(tc.steps, tc.warmup + 1) - tc.warmup
    peak = f32(tc.lr)
    if step < warmup:
        frac = f32(1) - f32(min(max(step, 0), warmup)) / f32(warmup)
        return float((f32(0.0) - peak) * frac + peak)
    count = f32(min(float(step - warmup), float(decay)))
    cosine = f32(0.5) * (f32(1) + _cosf(f32(np.pi) * count / f32(decay)))
    return float(peak * (f32(1) * cosine + f32(0)))


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.restype, lib.cosf.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib.cosf


def _cosf(x: np.float32) -> np.float32:
    """The C library's single-precision cosine — what XLA's CPU backend
    computes for a float32 ``cos``, to the bit (numpy's float32 ``cos``
    differs from it by an ulp at some arguments)."""
    return np.float32(_libm_cosf()(float(x)))


def _pairs_from_bundles(cfg: TrainConfig) -> tuple[list[str], list[str]]:
    """(query, gold-document text) pairs pooled over the training bundles."""
    queries: list[str] = []
    docs: list[str] = []
    for seed in cfg.seeds:
        bundle = build_bundle(n_docs=cfg.n_docs, n_queries=cfg.n_queries, seed=seed)
        by_id = {d.id: d.text for d in bundle.documents}
        for question, gold_id in bundle.queries:
            queries.append(question)
            docs.append(by_id[gold_id])
    return queries, docs


def _tokenize(texts: list[str], tokenizer, max_len: int) -> np.ndarray:
    out = np.full((len(texts), max_len), tokenizer.pad_id, np.int32)
    for i, t in enumerate(texts):
        ids = tokenizer.encode(t, add_bos=True)[:max_len]
        out[i, : len(ids)] = ids
    return out


def train_encoder(enc_cfg: Optional[EncoderConfig] = None,
                  train_cfg: Optional[TrainConfig] = None, out_path: str = "",
                  seed: int = 0, log_every: int = 50, device=None,
                  params: Optional[dict] = None) -> tuple[dict, EncoderConfig, dict]:
    """Train the bi-encoder on ``device`` (the card by default); returns
    (float32 params, enc_cfg, history). ``params`` (float32 leaves, such as
    a JAX init carried across with ``encoder_from_jax``) replaces the
    random init from ``seed``. ``history`` holds JAX's keys (``loss`` as
    ``(step, loss)`` every ``log_every`` steps and at the last, ``steps``,
    ``pairs``, ``wall_s``) and each step's milliseconds (``step_ms``,
    measured to the device's end of the step). With ``out_path``, saves a
    ``load_model`` checkpoint of family ``encoder``."""
    from sentio_tpu_torch.models.tokenizer import ByteTokenizer
    from sentio_tpu_torch.models.transformer import encoder_forward, init_encoder, mean_pool

    dev = resolve_device(device)
    enc_cfg = enc_cfg or EncoderConfig(vocab_size=512, dim=256, n_layers=4, n_heads=4,
                                       mlp_dim=1024, max_len=512)
    tc = train_cfg or TrainConfig()
    tokenizer = ByteTokenizer(enc_cfg.vocab_size)

    q_texts, d_texts = _pairs_from_bundles(tc)
    q_ids = torch.as_tensor(_tokenize(q_texts, tokenizer, tc.q_len), device=dev)
    d_ids = torch.as_tensor(_tokenize(d_texts, tokenizer, tc.d_len), device=dev)
    n = len(q_texts)
    logger.info("train_encoder: %d pairs, cfg dim=%d layers=%d", n, enc_cfg.dim,
                enc_cfg.n_layers)

    if params is None:
        g = torch.Generator(device=dev)
        g.manual_seed(seed)
        params = init_encoder(enc_cfg, g, dev, dtype=torch.float32)
    leaves = param_leaves(params)
    for leaf in leaves:
        if leaf.dtype != torch.float32:
            raise ValueError(f"master weights must be float32, got {leaf.dtype}")
        leaf.requires_grad_(True)
    opt = torch.optim.AdamW(leaves, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    pad = tokenizer.pad_id
    labels = torch.arange(tc.batch, device=dev)

    def embed(ids: torch.Tensor) -> torch.Tensor:
        # mean_pool returns L2-normalized float32: the serving embedding
        mask = ids != pad
        return mean_pool(encoder_forward(params, enc_cfg, ids, mask, attn_fn=None), mask)

    def loss_fn(qb: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
        logits = embed(qb) @ embed(db).T / tc.tau  # [B, B]
        lab = labels[: logits.shape[0]]
        # symmetric: query→doc and doc→query both pull the diagonal up
        return 0.5 * (F.cross_entropy(logits, lab) + F.cross_entropy(logits.T, lab))

    order = np.random.default_rng(seed).permutation(n)
    history: dict = {"loss": [], "steps": tc.steps, "pairs": n, "step_ms": []}
    t0 = time.perf_counter()
    for i in range(tc.steps):
        t_step = time.perf_counter()
        lo = (i * tc.batch) % max(n - tc.batch, 1)
        idx = torch.as_tensor(order[lo : lo + tc.batch], device=dev)
        for group in opt.param_groups:
            group["lr"] = lr_at(i, tc)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(q_ids[idx], d_ids[idx])
        loss.backward()
        opt.step()
        if i % log_every == 0 or i == tc.steps - 1:
            lv = float(loss.detach())
            history["loss"].append((i, round(lv, 4)))
            logger.info("train_encoder step %d/%d loss %.4f", i, tc.steps, lv)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history["step_ms"].append((time.perf_counter() - t_step) * 1e3)
        if (i + 1) % (len(order) // tc.batch or 1) == 0:
            order = np.random.default_rng(seed + i + 1).permutation(n)
    history["wall_s"] = round(time.perf_counter() - t0, 1)
    for leaf in leaves:
        leaf.requires_grad_(False)

    if out_path:
        from sentio_tpu_torch.runtime.weights import encoder_to_jax, save_pytree

        save_pytree(out_path, encoder_to_jax(params), meta={
            "family": "encoder",
            "config": dataclasses.asdict(enc_cfg),
            "trained": {"objective": "symmetric-infonce", "pairs": n, "steps": tc.steps,
                        "final_loss": history["loss"][-1][1],
                        "bundle_seeds": list(tc.seeds)},
        })
        logger.info("train_encoder: saved checkpoint to %s", out_path)
    return params, enc_cfg, history


def param_leaves(tree: dict) -> list[torch.Tensor]:
    """A parameter tree's tensors in sorted-key order."""
    out: list[torch.Tensor] = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(param_leaves(value) if isinstance(value, dict) else [value])
    return out


def eval_recall(params: dict, enc_cfg: EncoderConfig, n_docs: int = 1024,
                n_queries: int = 64, seed: int = 0, top_k: int = 10, device=None) -> float:
    """recall@k of an encoder on the eval bundle (seed 0, never trained
    on), through the serving embedder and dense index the eval measures
    (on the card, the flash kernel in every encoder layer)."""
    from sentio_tpu_torch.config import EmbedderConfig
    from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
    from sentio_tpu_torch.ops.embedder import TorchEmbedder

    dev = resolve_device(device)
    bundle = build_bundle(n_docs=n_docs, n_queries=n_queries, seed=seed)
    embedder = TorchEmbedder(EmbedderConfig(batch_size=128), params=params,
                             model_config=enc_cfg, device=dev)
    try:
        vecs = embedder.embed_many([d.text for d in bundle.documents])
        index = TorchDenseIndex(enc_cfg.dim, device=dev)
        index.add(bundle.documents, vecs)
        hits = 0
        for question, gold_id in bundle.queries:
            q = embedder.embed_many([question])[0]
            got = [d.id for d, _ in index.search(q.reshape(-1), top_k)]
            hits += gold_id in got
    finally:
        embedder.close()
    return hits / len(bundle.queries)
