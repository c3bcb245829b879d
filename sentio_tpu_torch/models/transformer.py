"""Bidirectional transformer encoder (BERT/XLM-R family) in PyTorch — the
counterpart of ``sentio_tpu/models/transformer.py``.

Backbone of the bi-encoder embedder and of the cross-encoder reranker:
post-LN residual blocks with learned positions and token-type embeddings.
Plain functions over a parameter dict (see :mod:`.layers` for its layout);
``attn_fn`` is the kernel seam — the bidirectional flash kernel takes
per-row key lengths instead of a ``[B, T]`` mask.

Tensor parallel (``params`` a :class:`~..parallel.sharding.TPShards` under
``ENCODER_TP_RULES``): q/k/v and ``w_in`` are column-sharded, ``wo`` and
``w_out`` row-sharded, so a block sums over ``tp`` twice; a replicated
bias of a column-sharded layer is cut to the shard's columns, and that of
a row-sharded one is added once, after the sum, as XLA places them. When
the heads divide over ``tp`` each shard attends its own heads (one
``attn_fn`` launch a shard, JAX's ``select_encoder_attn_fn``); otherwise
the shards' q/k/v are gathered and plain attention runs over every head.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.parallel.collectives import all_gather, broadcast, psum
from sentio_tpu_torch.parallel.sharding import TPShards

Tensor = torch.Tensor


@dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32_000
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    max_len: int = 512
    n_types: int = 2
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def tiny(cls) -> "EncoderConfig":
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=2, mlp_dim=128, max_len=128)

    @classmethod
    def base(cls) -> "EncoderConfig":
        return cls(vocab_size=250_002, dim=1024, n_layers=24, n_heads=16, mlp_dim=4096, max_len=8192)


# ------------------------------------------------------------------ init


def normal_matrix(shape, std: float, generator: torch.Generator, device,
                  dtype: torch.dtype, truncate: bool = True) -> Tensor:
    """Normal(0, std) drawn on ``device`` from ``generator``, clipped at
    ±2 std like the JAX package's truncated-normal fan-in init."""
    x = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    if truncate:
        x.clamp_(-2.0, 2.0)
    return x.mul_(std)


def dense_init(in_dim: int, out_dim: int, generator, device, dtype,
               with_bias: bool = True) -> dict:
    p = {"weight": normal_matrix((out_dim, in_dim), in_dim ** -0.5,
                                 generator, device, dtype)}
    if with_bias:
        p["bias"] = torch.zeros(out_dim, device=device, dtype=dtype)
    return p


def embed_init(vocab: int, dim: int, generator, device, dtype) -> dict:
    return {"embedding": normal_matrix((vocab, dim), 0.02, generator, device,
                                       dtype, truncate=False)}


def layernorm_init(dim: int, device) -> dict:
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def init_encoder(cfg: EncoderConfig, generator: torch.Generator, device,
                 dtype: Optional[torch.dtype] = None) -> dict:
    """Random weights made on ``device``: matrices and tables in ``dtype``
    (default: the config's compute dtype), norm parameters in float32."""
    dt = dtype or cfg.torch_dtype
    params: dict = {
        "embed_tokens": embed_init(cfg.vocab_size, cfg.dim, generator, device, dt),
        "embed_positions": embed_init(cfg.max_len, cfg.dim, generator, device, dt),
        "embed_types": embed_init(cfg.n_types, cfg.dim, generator, device, dt),
        "embed_norm": layernorm_init(cfg.dim, device),
    }
    for i in range(cfg.n_layers):
        params[f"layers_{i}"] = {
            "attn": {
                name: dense_init(cfg.dim, cfg.dim, generator, device, dt)
                for name in ("wq", "wk", "wv", "wo")
            },
            "attn_norm": layernorm_init(cfg.dim, device),
            "mlp": {
                "w_in": dense_init(cfg.dim, cfg.mlp_dim, generator, device, dt),
                "w_out": dense_init(cfg.mlp_dim, cfg.dim, generator, device, dt),
            },
            "mlp_norm": layernorm_init(cfg.dim, device),
        }
    return params


# --------------------------------------------------------------- forward


def encoder_forward(params: dict, cfg: EncoderConfig, ids: Tensor, mask: Tensor,
                    type_ids: Optional[Tensor] = None, attn_fn=None) -> Tensor:
    """ids/mask: [B, T] (mask True = real token) → hidden [B, T, D].
    ``attn_fn(q, k, v, kv_lens)``: right-padded masks reduce to per-row
    lengths for the kernel; None uses masked plain attention."""
    if isinstance(params, TPShards):
        return tp_encoder_forward(params, cfg, ids, mask, type_ids, attn_fn)
    x = _embed_input(params, cfg, ids, type_ids)
    attn_mask = mask[:, None, None, :].bool()  # [B,1,1,T] keys masked
    kv_lens = mask.int().sum(dim=1, dtype=torch.int32) if attn_fn is not None else None
    for i in range(cfg.n_layers):
        x = _block(params[f"layers_{i}"], cfg, x, attn_mask, attn_fn, kv_lens)
    return x


def _block(lp: dict, cfg: EncoderConfig, x: Tensor, attn_mask: Tensor,
           attn_fn=None, kv_lens: Optional[Tensor] = None) -> Tensor:
    dt = cfg.torch_dtype
    b, t, d = x.shape
    h, hd = cfg.n_heads, cfg.head_dim

    q = L.dense(lp["attn"]["wq"], x, dt).reshape(b, t, h, hd)
    k = L.dense(lp["attn"]["wk"], x, dt).reshape(b, t, h, hd)
    v = L.dense(lp["attn"]["wv"], x, dt).reshape(b, t, h, hd)
    if attn_fn is not None:
        attn_out = attn_fn(q, k, v, kv_lens).reshape(b, t, d)
    else:
        attn_out = L.attention(q, k, v, attn_mask, dt).reshape(b, t, d)
    x = L.layernorm(lp["attn_norm"], x + L.dense(lp["attn"]["wo"], attn_out, dt))

    # jax.nn.gelu defaults to the tanh approximation
    hidden = F.gelu(L.dense(lp["mlp"]["w_in"], x, dt), approximate="tanh")
    return L.layernorm(lp["mlp_norm"], x + L.dense(lp["mlp"]["w_out"], hidden, dt))


def _embed_input(params: dict, cfg: EncoderConfig, ids: Tensor,
                 type_ids: Optional[Tensor]) -> Tensor:
    dt = cfg.torch_dtype
    positions = torch.arange(ids.shape[1], device=ids.device)[None, :]
    x = (L.embed(params["embed_tokens"], ids, dt)
         + L.embed(params["embed_positions"], positions, dt))
    if type_ids is not None:
        x = x + L.embed(params["embed_types"], type_ids, dt)
    return L.layernorm(params["embed_norm"], x)


def _columns(lp: dict, x: Tensor, shard: int, dt: torch.dtype) -> Tensor:
    """A column-sharded layer's slice of the output: the shard's weight
    rows, and its columns of the replicated bias."""
    y = F.linear(x.to(dt), lp["weight"].to(dt))
    if "bias" in lp:
        n = lp["weight"].shape[0]
        y = y + lp["bias"][shard * n:(shard + 1) * n].to(dt)
    return y


def _partial(lp: dict, x: Tensor, dt: torch.dtype) -> Tensor:
    """A row-sharded layer's partial product over the shard's inputs."""
    return F.linear(x.to(dt), lp["weight"].to(dt))


def _rows(parts: list, lp: dict, home: torch.device, dt: torch.dtype) -> Tensor:
    """A row-sharded layer's output: the shards' partial products summed
    over ``tp``, then the replicated bias once."""
    y = psum(parts, home)
    return y + lp["bias"].to(dt) if "bias" in lp else y


def tp_encoder_forward(shards: TPShards, cfg: EncoderConfig, ids: Tensor, mask: Tensor,
                       type_ids: Optional[Tensor] = None, attn_fn=None) -> Tensor:
    """:func:`encoder_forward` over tensor-parallel shards; the embeddings
    and norms (replicated) run on the first shard's device."""
    dt = cfg.torch_dtype
    devs, home, first = shards.devices, shards.devices[0], shards[0]
    b, t = ids.shape
    hd, tp = cfg.head_dim, shards.tp
    per_shard = cfg.n_heads % tp == 0
    x = _embed_input(first, cfg, ids, type_ids)
    attn_mask = mask[:, None, None, :].bool()
    masks = broadcast(attn_mask, devs)
    lens = ([None] * tp if attn_fn is None else
            broadcast(mask.int().sum(dim=1, dtype=torch.int32), devs))
    for i in range(cfg.n_layers):
        name = f"layers_{i}"
        xs = broadcast(x, devs)
        qkv = [[_columns(tree[name]["attn"][w], xs[s], s, dt) for w in ("wq", "wk", "wv")]
               for s, tree in enumerate(shards)]
        if per_shard:
            outs = []
            for s, (q, k, v) in enumerate(qkv):
                h = q.shape[-1] // hd
                q, k, v = (z.reshape(b, t, h, hd) for z in (q, k, v))
                out = (attn_fn(q, k, v, lens[s]) if attn_fn is not None
                       else L.attention(q, k, v, masks[s], dt))
                outs.append(out.reshape(b, t, h * hd))
        else:
            # heads split across shards: every head's q/k/v on the first
            # device, then each shard's columns of the output for its wo
            q, k, v = (all_gather([p[j] for p in qkv], home).reshape(b, t, cfg.n_heads, hd)
                       for j in range(3))
            full = L.attention(q, k, v, attn_mask, dt).reshape(b, t, cfg.dim)
            width = cfg.dim // tp
            outs = [broadcast(full[..., s * width:(s + 1) * width], [d])[0]
                    for s, d in enumerate(devs)]
        attn_out = _rows([_partial(tree[name]["attn"]["wo"], o, dt)
                          for o, tree in zip(outs, shards)], first[name]["attn"]["wo"], home, dt)
        x = L.layernorm(first[name]["attn_norm"], x + attn_out)
        xs = broadcast(x, devs)
        hidden = [F.gelu(_columns(tree[name]["mlp"]["w_in"], xs[s], s, dt), approximate="tanh")
                  for s, tree in enumerate(shards)]
        mlp_out = _rows([_partial(tree[name]["mlp"]["w_out"], hh, dt)
                         for hh, tree in zip(hidden, shards)], first[name]["mlp"]["w_out"],
                        home, dt)
        x = L.layernorm(first[name]["mlp_norm"], x + mlp_out)
    return x


def mean_pool(hidden: Tensor, mask: Tensor) -> Tensor:
    """Masked mean over tokens → L2-normalized embedding [B, D], float32."""
    m = mask.float()[:, :, None]
    summed = (hidden.float() * m).sum(dim=1)
    pooled = summed / m.sum(dim=1).clamp_min(1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def cls_pool(hidden: Tensor) -> Tensor:
    """First-token representation [B, D] (cross-encoder head input)."""
    return hidden[:, 0, :].float()
