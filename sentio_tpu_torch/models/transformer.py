"""Bidirectional transformer encoder (BERT/XLM-R family) in PyTorch — the
counterpart of ``sentio_tpu/models/transformer.py``.

Backbone of the bi-encoder embedder and of the cross-encoder reranker:
post-LN residual blocks with learned positions and token-type embeddings.
Plain functions over a parameter dict (see :mod:`.layers` for its layout);
``attn_fn`` is the kernel seam — the bidirectional flash kernel takes
per-row key lengths instead of a ``[B, T]`` mask.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from sentio_tpu_torch.models import layers as L

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
    dt = cfg.torch_dtype
    t = ids.shape[1]
    positions = torch.arange(t, device=ids.device)[None, :]
    x = (L.embed(params["embed_tokens"], ids, dt)
         + L.embed(params["embed_positions"], positions, dt))
    if type_ids is not None:
        x = x + L.embed(params["embed_types"], type_ids, dt)
    x = L.layernorm(params["embed_norm"], x)

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


def mean_pool(hidden: Tensor, mask: Tensor) -> Tensor:
    """Masked mean over tokens → L2-normalized embedding [B, D], float32."""
    m = mask.float()[:, :, None]
    summed = (hidden.float() * m).sum(dim=1)
    pooled = summed / m.sum(dim=1).clamp_min(1.0)
    return pooled / pooled.norm(dim=-1, keepdim=True).clamp_min(1e-9)


def cls_pool(hidden: Tensor) -> Tensor:
    """First-token representation [B, D] (cross-encoder head input)."""
    return hidden[:, 0, :].float()
