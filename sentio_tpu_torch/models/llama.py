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

import functools
from dataclasses import dataclass
from typing import Optional, Union

import torch
import torch.nn.functional as F

from sentio_tpu_torch.kernels import MeshAttention
from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.transformer import dense_init, embed_init
from sentio_tpu_torch.parallel.collectives import all_gather, broadcast, psum
from sentio_tpu_torch.parallel.sharding import ShardedParams, TPShards, leaves

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


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Each shard holds whole kv heads (JAX's pool refuses the rest)."""
    if cfg.n_kv_heads % tp != 0:
        raise ValueError(f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}")


def init_tp_cache(cfg: LlamaConfig, batch: int, max_len: int, shards: TPShards) -> list:
    """One cache per shard, ``[L, B, S, Hkv/tp, D]`` each on its device:
    the kv heads shard over ``tp`` as the wk / wv columns do."""
    check_tp(cfg, shards.tp)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads // shards.tp, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=d),
             "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=d)} for d in shards.devices]


def tp_embed(shards: TPShards, ids: Tensor, dtype: torch.dtype) -> Tensor:
    """The vocabulary-sharded lookup: each shard looks up the ids in its
    rows (zero elsewhere), and the shards' rows are summed."""
    parts = []
    for i, (tree, ids_s) in enumerate(zip(shards, broadcast(ids, shards.devices))):
        table = tree["embed_tokens"]["embedding"]
        local = ids_s.long() - i * table.shape[0]
        mine = (local >= 0) & (local < table.shape[0])
        rows = F.embedding(local.clamp(0, table.shape[0] - 1), table).to(dtype)
        parts.append(torch.where(mine[..., None], rows, torch.zeros((), dtype=dtype,
                                                                    device=rows.device)))
    return psum(parts, shards.devices[0])


class ShardInputs:
    """One call's per-shard inputs on each tp shard's device: positions,
    pad mask, cache offset and the rope tables."""

    def __init__(self, cfg: LlamaConfig, devs: list, positions: Tensor,
                 pad_mask: Optional[Tensor], cache_index: Union[int, Tensor],
                 rope_len: int) -> None:
        self.devs = devs
        self.ropes = [L.rope_frequencies(cfg.head_dim, rope_len, cfg.rope_theta, d)
                      for d in devs]
        self.positions = broadcast(positions.long(), devs)
        self.pad = broadcast(pad_mask, devs) if pad_mask is not None else [None] * len(devs)
        self.index = (broadcast(cache_index, devs) if isinstance(cache_index, Tensor)
                      else [cache_index] * len(devs))


def tp_block(lps: list, cfg: LlamaConfig, x: Tensor, inputs: ShardInputs, layer: int = 0,
             caches: Optional[list] = None, attn_fn=None, mlp=None) -> Tensor:
    """One pre-norm block over tensor-parallel shards (``lps``: each
    shard's layer tree): each shard runs its heads' attention (writing its
    own cache at ``layer``, launching ``attn_fn`` on its heads) and its
    slice of the MLP; the partial outputs of ``wo`` and ``w_down`` are
    summed over ``tp`` (two sums a block) and the norms run once on the
    first shard's device. ``mlp(xm)``, where given, replaces the SwiGLU
    (a MoE layer's routed experts)."""
    devs, home = inputs.devs, inputs.devs[0]
    caches = caches if caches is not None else [None] * len(devs)
    xn = broadcast(L.rmsnorm(lps[0]["attn_norm"], x, cfg.norm_eps), devs)
    x = x + psum([_attn(lp["attn"], cfg, xn[s], inputs.positions[s], *inputs.ropes[s], layer,
                        caches[s], inputs.index[s], inputs.pad[s], attn_fn)
                  for s, lp in enumerate(lps)], home)
    xm = L.rmsnorm(lps[0]["mlp_norm"], x, cfg.norm_eps)
    if mlp is not None:
        return x + mlp(xm)
    xm = broadcast(xm, devs)
    return x + psum([_mlp(lp["mlp"], cfg, xm[s]) for s, lp in enumerate(lps)], home)


def tp_forward(shards: TPShards, cfg: LlamaConfig, ids: Tensor,
               positions: Optional[Tensor] = None, cache: Optional[list] = None,
               cache_index: Union[int, Tensor] = 0, pad_mask: Optional[Tensor] = None,
               attn_fn=None, logit_index: Optional[Tensor] = None, mlp=None
               ) -> tuple[Tensor, Optional[list]]:
    """:func:`llama_forward` over tensor-parallel shards: each layer is a
    :func:`tp_block`, and the vocabulary-sharded logits are gathered on the
    first shard's device. ``mlp(layer, xm)``, where given, replaces each
    layer's SwiGLU (the MoE model's ep × tp experts)."""
    dt = cfg.torch_dtype
    devs, home = shards.devices, shards.devices[0]
    check_tp(cfg, shards.tp)
    b, t = ids.shape
    if positions is None:
        positions = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    rope_len = cache[0]["k"].shape[2] if cache is not None else max(t, cfg.max_len)
    inputs = ShardInputs(cfg, devs, positions, pad_mask, cache_index, rope_len)

    x = tp_embed(shards, ids, dt)
    for i in range(cfg.n_layers):
        name = f"layers_{i}"
        x = tp_block([tree[name] for tree in shards], cfg, x, inputs, i, cache, attn_fn,
                     None if mlp is None else functools.partial(mlp, i))
    if logit_index is not None:
        x = x[torch.arange(b, device=x.device), logit_index.to(x.device)][:, None]
    x = broadcast(L.rmsnorm(shards[0]["final_norm"], x, cfg.norm_eps), devs)
    logits = all_gather([L.dense(tree["lm_head"], x[s], dt)
                         for s, tree in enumerate(shards)], home)
    return logits.float(), cache


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
    b, t, _ = x.shape
    hd = cfg.head_dim
    # the heads this shard holds: all of them, or H/tp and Hkv/tp under tp
    h, hkv = lp["wq"]["weight"].shape[0] // hd, lp["wk"]["weight"].shape[0] // hd

    q = L.dense(lp["wq"], x, dt).reshape(b, t, h, hd)
    k = L.dense(lp["wk"], x, dt).reshape(b, t, hkv, hd)
    v = L.dense(lp["wv"], x, dt).reshape(b, t, hkv, hd)
    q = L.apply_rope(q, positions, cos, sin)
    k = L.apply_rope(k, positions, cos, sin)

    # kernels apply to multi-token causal attention whose query block starts
    # at position 0 (training, a prefill written at slot 0): exactly when
    # positions == arange(t); decode and a prefill over prior KV (per-row
    # offsets) use the masked plain path. A MeshAttention runs its
    # per-shard form: q holds one tp shard's heads of one data group's rows
    # (or the whole model's), already split as its global form would
    at_zero = cache is None or (isinstance(cache_index, int) and cache_index == 0)
    use_kernel = attn_fn is not None and t > 1 and at_zero
    if isinstance(attn_fn, MeshAttention):
        attn_fn = attn_fn.shard
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
        out = attn_fn(q, k_full, v_full, kv_lens).reshape(b, t, h * hd)
    else:
        out = L.attention(q, k_full, v_full, mask, dt).reshape(b, t, h * hd)
    return L.dense(lp["wo"], out, dt)


def _mlp(lp: dict, cfg: LlamaConfig, x: Tensor) -> Tensor:
    dt = cfg.torch_dtype
    gate = F.silu(L.dense(lp["w_gate"], x, dt))
    return L.dense(lp["w_down"], gate * L.dense(lp["w_up"], x, dt), dt)


def _layer(lp: dict, cfg: LlamaConfig, x: Tensor, positions: Tensor, cos: Tensor,
           sin: Tensor, layer: int, cache: Optional[Cache], cache_index: Union[int, Tensor],
           pad_mask: Optional[Tensor], attn_fn=None) -> Tensor:
    x = x + _attn(lp["attn"], cfg, L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps), positions,
                  cos, sin, layer, cache, cache_index, pad_mask, attn_fn)
    return x + _mlp(lp["mlp"], cfg, L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps))


def block_forward(lp: dict, cfg: LlamaConfig, x: Tensor, positions: Tensor, cos: Tensor,
                  sin: Tensor, pad_mask: Optional[Tensor] = None, attn_fn=None) -> Tensor:
    """One pre-norm transformer block on activations x [B, T, D], the
    cache-free (training / scoring) path: what the pipeline executor
    (``parallel/pipeline.py``) runs over a stage's layer stack (a
    tensor-parallel stage runs :func:`tp_block`)."""
    return _layer(lp, cfg, x, positions, cos, sin, 0, None, 0, pad_mask, attn_fn)


def layer_of(stacked_layers: dict, i: int) -> dict:
    """Layer ``i``'s tree of a stacked ``layers`` tree: views of the
    stacks."""
    return {k: layer_of(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked_layers.items()}


def stack_layer_params(params: dict, cfg: LlamaConfig) -> dict:
    """Per-layer subtrees ``layers_i`` as one stacked tree with a leading
    layer dim: ``{"embed_tokens", "lm_head", "final_norm", "layers"}``,
    every leaf of ``layers`` ``[n_layers, ...]`` (the port's ``[out, in]``
    matrices stacked: ``[L, out, in]``). The form the pipeline executor
    shards over ``pp`` (leading dim = stage)."""
    per_layer = [params[f"layers_{i}"] for i in range(cfg.n_layers)]

    def stack(trees: list):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    return {"embed_tokens": params["embed_tokens"], "lm_head": params["lm_head"],
            "final_norm": params["final_norm"], "layers": stack(per_layer)}


def unstack_layer_params(stacked: dict, cfg: LlamaConfig) -> dict:
    """Inverse of :func:`stack_layer_params` (each layer's leaves are views
    of the stacks)."""
    params = {"embed_tokens": stacked["embed_tokens"], "lm_head": stacked["lm_head"],
              "final_norm": stacked["final_norm"]}
    for i in range(cfg.n_layers):
        params[f"layers_{i}"] = layer_of(stacked["layers"], i)
    return params


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

    Tensor parallel: ``params`` a :class:`TPShards` (one data coordinate's
    shards, :func:`~..parallel.sharding.shard_params` under
    ``LLAMA_TP_RULES``) and ``cache`` a list of per-shard caches
    (:func:`init_tp_cache`) run :func:`tp_forward`.
    """
    if isinstance(params, TPShards):
        return tp_forward(params, cfg, ids, positions, cache, cache_index, pad_mask, attn_fn,
                          logit_index)
    dt = cfg.torch_dtype
    b, t = ids.shape
    if positions is None:
        positions = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    positions = positions.long()
    rope_len = cache["k"].shape[2] if cache is not None else max(t, cfg.max_len)
    cos, sin = L.rope_frequencies(cfg.head_dim, rope_len, cfg.rope_theta, ids.device)

    x = L.embed(params["embed_tokens"], ids, dt)
    for i in range(cfg.n_layers):
        x = _layer(params[f"layers_{i}"], cfg, x, positions, cos, sin, i, cache, cache_index,
                   pad_mask, attn_fn)
    if logit_index is not None:
        x = x[torch.arange(b, device=x.device), logit_index][:, None]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.dense(params["lm_head"], x, dt)
    return logits.float(), cache


def nll_sums(logits: Tensor, ids: Tensor, mask: Tensor) -> tuple[Tensor, Tensor]:
    """(Σ w·nll, Σ w) of next-token cross-entropy: logits [B, T, V] of
    ``ids[:, :-1]``, targets ``ids[:, 1:]``, weights ``mask[:, 1:]``."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, ids[:, 1:].long()[..., None])[..., 0]
    weights = mask[:, 1:].float()
    return (nll * weights).sum(), weights.sum()


def weighted_mean(terms: list, device) -> Tensor:
    """The global weighted mean of data groups' ``(Σ w·nll, Σ w)``: both
    sums are added over the groups before the one division, as JAX's
    loss over a dp-sharded batch reads."""
    nll = psum([n for n, _ in terms], device)
    weight = psum([w for _, w in terms], device)
    return nll / weight.clamp_min(1.0)


def home_device(params) -> torch.device:
    """Where a tree (or a group's shards) computes: its first shard's
    device, or its tensors'."""
    if isinstance(params, TPShards):
        return params.devices[0]
    return next(leaf for _, leaf in leaves(params)).device


def llama_loss(params, cfg: LlamaConfig, ids: Tensor, mask: Tensor) -> Tensor:
    """Mean next-token cross-entropy over unpadded positions: weights
    ``mask[:, 1:]``, divided by ``max(Σw, 1)``. ``params`` a plain tree, a
    :class:`TPShards` (:func:`tp_forward`), or a
    :class:`~..parallel.sharding.ShardedParams`, whose batch splits over
    its data coordinates where it divides (each group's sums meet in
    :func:`weighted_mean`). Plain attention, as JAX's (no ``attn_fn``):
    no forward-only kernel sits under autograd."""
    groups = (params.groups(ids.shape[0]) if isinstance(params, ShardedParams)
              else [(slice(None), params)])
    terms = []
    for rows, group in groups:
        dev = home_device(group)
        g_ids, g_mask = ids[rows].to(dev), mask[rows].to(dev)
        logits, _ = llama_forward(group, cfg, g_ids[:, :-1], pad_mask=g_mask[:, :-1])
        terms.append(nll_sums(logits, g_ids, g_mask))
    return weighted_mean(terms, home_device(groups[0][1]))
