"""Shared neural net primitives in PyTorch — the counterpart of
``sentio_tpu/models/layers.py``.

Parameters are plain nested dicts of tensors with the JAX package's paths
(``layers_3/attn/wq``), so a parameter tree carries across by name. One
layout change: a dense layer's matrix is stored as ``weight`` in PyTorch's
``[out, in]`` order (``F.linear``), where the JAX tree stores ``kernel`` as
``[in, out]``; :mod:`sentio_tpu_torch.runtime.weights` owns the transpose.

Compute follows the JAX package's dtype policy: matrices are cast to the
compute dtype at use (a no-op when they are stored in it), norms and the
softmax run in float32.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor

__all__ = [
    "dense", "embed", "layernorm", "rmsnorm", "rope_frequencies",
    "apply_rope", "attention", "repeat_kv", "causal_mask",
]


def dense(params: dict, x: Tensor, dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """``x @ W (+ b)`` in ``dtype``; ``params["weight"]`` is ``[out, in]``."""
    y = F.linear(x.to(dtype), params["weight"].to(dtype))
    if "bias" in params:
        y = y + params["bias"].to(dtype)
    return y


def embed(params: dict, ids: Tensor, dtype: torch.dtype = torch.bfloat16) -> Tensor:
    return F.embedding(ids.long(), params["embedding"]).to(dtype)


def layernorm(params: dict, x: Tensor, eps: float = 1e-6) -> Tensor:
    # norm math in fp32, output back in the input dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)


def rmsnorm(params: dict, x: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (y * params["scale"].float()).to(x.dtype)


@functools.lru_cache(maxsize=16)
def _rope_tables(head_dim: int, max_len: int, theta: float,
                 device: torch.device) -> tuple[Tensor, Tensor]:
    # float64 numpy, then float32 — a float32 table drifts at the high
    # positions of an 8K window with theta 5e5
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))
    freqs = np.outer(np.arange(max_len), inv_freq)
    return (torch.tensor(np.cos(freqs), dtype=torch.float32, device=device),
            torch.tensor(np.sin(freqs), dtype=torch.float32, device=device))


def rope_frequencies(head_dim: int, max_len: int, theta: float = 10_000.0,
                     device=None) -> tuple[Tensor, Tensor]:
    """Precomputed cos/sin tables [max_len, head_dim//2], float32. Cached
    per (shape, theta, device): the tables are read-only."""
    return _rope_tables(int(head_dim), int(max_len), float(theta),
                        torch.device(device or "cpu"))


def apply_rope(x: Tensor, positions: Tensor, cos: Tensor, sin: Tensor) -> Tensor:
    """Rotate q/k by halves (not interleaved pairs). x: [B, T, H, D];
    positions: [B, T] absolute positions."""
    c = cos[positions][:, :, None, :]  # [B, T, 1, D/2]
    s = sin[positions][:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# float32 scores one plain-attention pass may hold; more queries than fit
# run in blocks of them (each query row's softmax is its own)
ATTENTION_SCORE_BYTES = 1 << 30


def attention(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
              dtype: torch.dtype = torch.bfloat16) -> Tensor:
    """Plain batched MHA core: q [B,T,H,D], k/v [B,S,H,D], mask broadcastable
    to [B,H,T,S] (True = attend). Softmax in fp32. A row with no key to
    attend averages all keys uniformly, as the JAX version does. Queries go
    in blocks whose float32 scores stay within ``ATTENTION_SCORE_BYTES``:
    one 8,192-token prefill row at Llama-3-8B (32 heads) would otherwise
    hold ~8.6 GB of scores several times over, and two engines sharing a
    card each hold their own."""
    b, t, h, _ = q.shape
    rows = max(ATTENTION_SCORE_BYTES // (b * h * k.shape[1] * 4), 1)
    if t > rows:
        def block(i: int) -> Optional[Tensor]:
            if mask is None or mask.shape[2] == 1:
                return mask
            return mask[:, :, i:i + rows]

        return torch.cat([attention(q[:, i:i + rows], k, v, block(i), dtype)
                          for i in range(0, t, rows)], dim=1)
    scale = 1.0 / np.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q.to(dtype), k.to(dtype))
    logits = logits.float() * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhts,bshd->bthd", weights.to(dtype), v.to(dtype))


def repeat_kv(x: Tensor, n_rep: int) -> Tensor:
    """GQA: [B,S,Hkv,D] -> [B,S,Hkv*n,D]."""
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def causal_mask(t: int, s: Optional[int] = None, offset: int = 0,
                device=None) -> Tensor:
    """[1, 1, T, S] boolean causal mask; ``offset`` shifts query positions."""
    s = s if s is not None else t
    qi = torch.arange(t, device=device)[:, None] + offset
    kj = torch.arange(s, device=device)[None, :]
    return (kj <= qi)[None, None, :, :]
