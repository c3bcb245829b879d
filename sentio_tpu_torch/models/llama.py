"""Decoder-only LM (Llama-3 family) in PyTorch — the counterpart of
``sentio_tpu/models/llama.py``: RMSNorm pre-norm, RoPE by halves, GQA,
SwiGLU.

Plain functions over a parameter dict (layout in :mod:`.layers`). The KV
cache is a dict ``{"k", "v"}`` of ``[L, B, S, Hkv, D]`` tensors. Unlike
the JAX version, which returns a fresh cache pytree, the cache is updated
in place (the returned dict is the same object): an eager program that
copied an 8B model's prefill cache per layer would double its memory.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.transformer import dense_init, embed_init

Tensor = torch.Tensor
Cache = dict  # {"k": [L,B,S,Hkv,D], "v": [L,B,S,Hkv,D]}


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    mlp_dim: int = 14_336
    max_len: int = 8192
    rope_theta: float = 500_000.0
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """CPU-test scale; byte-level vocab (ByteTokenizer round-trips)."""
        return cls(
            vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_dim=128, max_len=512, rope_theta=10_000.0,
        )


def init_llama(cfg: LlamaConfig, generator: torch.Generator, device,
               dtype: Optional[torch.dtype] = None) -> dict:
    """Random weights made on ``device``: matrices and the embedding table in
    ``dtype`` (default: the compute dtype), RMSNorm scales in float32."""
    dt = dtype or cfg.torch_dtype
    kv_dim = cfg.n_kv_heads * cfg.head_dim

    def lin(i, o):
        return dense_init(i, o, generator, device, dt, with_bias=False)

    def norm():
        return {"scale": torch.ones(cfg.dim, device=device)}

    params: dict = {
        "embed_tokens": embed_init(cfg.vocab_size, cfg.dim, generator, device, dt),
        "lm_head": lin(cfg.dim, cfg.vocab_size),
        "final_norm": norm(),
    }
    for i in range(cfg.n_layers):
        params[f"layers_{i}"] = {
            "attn_norm": norm(),
            "attn": {"wq": lin(cfg.dim, cfg.dim), "wk": lin(cfg.dim, kv_dim),
                     "wv": lin(cfg.dim, kv_dim), "wo": lin(cfg.dim, cfg.dim)},
            "mlp_norm": norm(),
            "mlp": {"w_gate": lin(cfg.dim, cfg.mlp_dim),
                    "w_up": lin(cfg.dim, cfg.mlp_dim),
                    "w_down": lin(cfg.mlp_dim, cfg.dim)},
        }
    return params


def init_cache(cfg: LlamaConfig, batch: int, max_len: int, device) -> Cache:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device)}


def _write_cache(cache_layer: Tensor, kv: Tensor, index: Union[int, Tensor]) -> None:
    """Write kv [B, T, Hkv, D] into cache_layer [B, S, Hkv, D] in place at
    sequence offset ``index``: an int, or a [B] tensor with each row's own
    offset. As JAX's ``dynamic_update_slice`` does, a start that would
    overhang the cache is clamped to S - T."""
    b, t = kv.shape[:2]
    s = cache_layer.shape[1]
    if isinstance(index, int):
        start = min(max(index, 0), s - t)
        cache_layer[:, start:start + t] = kv
        return
    start = index.long().clamp(0, s - t)
    cols = start[:, None] + torch.arange(t, device=kv.device)[None, :]
    cache_layer[torch.arange(b, device=kv.device)[:, None], cols] = kv


def _attn(lp: dict, cfg: LlamaConfig, x: Tensor, positions: Tensor, cos: Tensor,
          sin: Tensor, layer: int, cache: Optional[Cache], cache_index: Union[int, Tensor],
          pad_mask: Optional[Tensor], attn_fn=None) -> Tensor:
    dt = cfg.torch_dtype
    b, t, d = x.shape
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    q = L.dense(lp["wq"], x, dt).reshape(b, t, h, hd)
    k = L.dense(lp["wk"], x, dt).reshape(b, t, hkv, hd)
    v = L.dense(lp["wv"], x, dt).reshape(b, t, hkv, hd)
    q = L.apply_rope(q, positions, cos, sin)
    k = L.apply_rope(k, positions, cos, sin)

    # kernels apply to multi-token causal attention only (prefill/training);
    # decode and ragged offsets use the masked plain path
    use_kernel = attn_fn is not None and t > 1
    if cache is not None:
        # pad_mask is not read here, as in JAX: the causal mask over
        # absolute positions already hides the cache's unwritten tail
        _write_cache(cache["k"][layer], k.to(dt), cache_index)
        _write_cache(cache["v"][layer], v.to(dt), cache_index)
        k_full, v_full = cache["k"][layer], cache["v"][layer]
        s = k_full.shape[1]
        # query i (absolute pos = positions[:, i]) attends keys j <= pos_i
        kj = torch.arange(s, device=x.device)[None, None, None, :]
        mask = kj <= positions[:, None, :, None]  # [B,1,T,S]
        kv_lens = None
    else:
        mask = L.causal_mask(t, device=x.device)
        if pad_mask is not None:
            mask = mask & pad_mask[:, None, None, :]
        k_full, v_full = k, v
        kv_lens = pad_mask.sum(dim=1, dtype=torch.int32) if pad_mask is not None else None

    k_full = L.repeat_kv(k_full, h // hkv)
    v_full = L.repeat_kv(v_full, h // hkv)
    if use_kernel:
        out = attn_fn(q, k_full, v_full, kv_lens).reshape(b, t, d)
    else:
        out = L.attention(q, k_full, v_full, mask, dt).reshape(b, t, d)
    return L.dense(lp["wo"], out, dt)


def _mlp(lp: dict, cfg: LlamaConfig, x: Tensor) -> Tensor:
    dt = cfg.torch_dtype
    gate = F.silu(L.dense(lp["w_gate"], x, dt))
    return L.dense(lp["w_down"], gate * L.dense(lp["w_up"], x, dt), dt)


def llama_forward(params: dict, cfg: LlamaConfig, ids: Tensor,
                  positions: Optional[Tensor] = None, cache: Optional[Cache] = None,
                  cache_index: Union[int, Tensor] = 0, pad_mask: Optional[Tensor] = None,
                  attn_fn=None, logit_index: Optional[Tensor] = None
                  ) -> tuple[Tensor, Optional[Cache]]:
    """ids [B, T] → (logits [B, T, vocab] float32, cache); with
    ``logit_index`` (a [B] tensor of positions) only those rows' logits,
    [B, 1, vocab]: a prefill that samples from its last prompt token
    spares the LM head's product over every other position (at Llama-3-8B
    a 4,096-token row's full logits are 2 GB in float32).

    * Training / scoring: ``cache=None`` → causal attention over T.
    * Prefill: pass a fresh cache, ``positions = arange(T)``, index 0; the
      T new keys are written at ``cache_index``. A prefill over prior KV
      (a cache primed with each row's earlier tokens) passes ``cache_index``
      as a [B] tensor of per-row offsets and ``positions`` from there.
      (Decode runs over the page pool instead: ``runtime/paged.py``.)
    """
    dt = cfg.torch_dtype
    b, t = ids.shape
    if positions is None:
        positions = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    positions = positions.long()
    rope_len = cache["k"].shape[2] if cache is not None else max(t, cfg.max_len)
    cos, sin = L.rope_frequencies(cfg.head_dim, rope_len, cfg.rope_theta, ids.device)

    x = L.embed(params["embed_tokens"], ids, dt)
    for i in range(cfg.n_layers):
        lp = params[f"layers_{i}"]
        x = x + _attn(lp["attn"], cfg, L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                      positions, cos, sin, i, cache, cache_index, pad_mask, attn_fn)
        x = x + _mlp(lp["mlp"], cfg, L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))
    if logit_index is not None:
        x = x[torch.arange(b, device=x.device), logit_index][:, None]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.dense(params["lm_head"], x, dt)
    return logits.float(), cache
