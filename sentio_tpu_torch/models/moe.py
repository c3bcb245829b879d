"""Mixture-of-Experts decoder in PyTorch — the counterpart of
``sentio_tpu/models/moe.py``: the Llama block with its SwiGLU replaced by
``n_experts`` routed SwiGLU experts and a linear router, top-k routing with
renormalised gates over a fixed per-expert capacity
``C = ceil(G·k/E · capacity_factor)`` (G counts every row × token of the
call, padding included). Overflow is dropped in choice-priority order: all
first choices take their places before any second choice, and within a
choice tokens go in order; a dropped choice's residual passes untouched.

The semantics are JAX's; the dispatch is by index instead of one-hot
einsums (the ``"gec,gd->ecd"`` einsum costs G·E·C·D multiply-adds, which at
Mixtral width is most of a long prefill). Two routes compute the same
function:

* **capacity buffers** (``G <= CAPACITY_DISPATCH_ROWS``, and every call
  under CUDA graph capture: decode, a spec verify) — each kept choice is
  copied into its expert's slot of an ``[E, C, D]`` buffer and the experts
  run as three batched products over every slot, as JAX's einsums do. No
  host sync and no data-dependent shape, so a CUDA graph captures it;
* **grouped rows** (larger G outside capture: prefill) — the kept choices
  are sorted by expert and each expert multiplies only its own rows; the
  host reads the per-expert counts once a layer.

Rounding follows JAX's dtype policy: the router in float32, the expert
inputs, products and SwiGLU in the compute dtype, the gates rounded to it
before they weight the expert outputs. Expert stacks keep JAX's
``[E, in, out]`` layout (``torch.bmm`` reads it as is).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.llama import (
    Cache,
    LlamaConfig,
    _attn,
    home_device,
    init_llama,
    llama_forward,
    nll_sums,
    tp_forward,
    weighted_mean,
)
from sentio_tpu_torch.models.transformer import dense_init, embed_init, normal_matrix
from sentio_tpu_torch.parallel.collectives import psum
from sentio_tpu_torch.parallel.sharding import (
    LLAMA_TP_RULES,
    MOE_EP_RULES,
    Rules,
    ShardedParams,
    TPShards,
)

Tensor = torch.Tensor

# calls routing at most this many tokens use the capacity buffers (graph
# capturable); larger ones group rows by expert unless a graph is captured
CAPACITY_DISPATCH_ROWS = 256


@dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    n_experts: int = 8
    experts_per_token: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    @classmethod
    def tiny(cls) -> "MoeConfig":
        """CPU-test scale, byte-level vocab."""
        return cls(vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                   mlp_dim=128, max_len=512, rope_theta=10_000.0,
                   n_experts=4, experts_per_token=2)


def init_moe(cfg: MoeConfig, generator: torch.Generator, device,
             dtype: Optional[torch.dtype] = None) -> dict:
    """Random weights made on ``device``, laid out as ``init_llama``'s with
    each layer's ``mlp`` replaced by ``moe``: the router (a dense layer to
    ``n_experts``) and the expert stacks ``[E, in, out]``."""
    dt = dtype or cfg.torch_dtype
    kv_dim = cfg.n_kv_heads * cfg.head_dim

    def lin(i, o):
        return dense_init(i, o, generator, device, dt, with_bias=False)

    def stack(i, o):
        return normal_matrix((cfg.n_experts, i, o), i ** -0.5, generator, device, dt)

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
            "moe": {"router": lin(cfg.dim, cfg.n_experts),
                    "w_gate": stack(cfg.dim, cfg.mlp_dim),
                    "w_up": stack(cfg.dim, cfg.mlp_dim),
                    "w_down": stack(cfg.mlp_dim, cfg.dim)},
        }
    return params


def expert_capacity(cfg: MoeConfig, n_tokens: int) -> int:
    per_expert = n_tokens * cfg.experts_per_token / cfg.n_experts
    return max(1, math.ceil(per_expert * cfg.capacity_factor))


class Routing(NamedTuple):
    """One call's routing, choice-major: ``expert``, ``pos`` (the slot in
    the expert's buffer), ``keep`` and ``weight`` (the renormalised gate,
    0 where dropped) are ``[k, G]``; ``aux`` the Switch load-balance
    scalar."""

    expert: Tensor
    pos: Tensor
    keep: Tensor
    weight: Tensor
    aux: Tensor


def route(logits: Tensor, k: int, capacity: int, valid: Optional[Tensor] = None) -> Routing:
    """JAX's ``route_topk`` in compact form. logits [G, E] (float32);
    ``valid`` [G] bool masks padding out entirely: it takes no capacity
    and adds nothing to the aux statistics. The aux loss counts choices
    before drops (clipping must not cap the imbalance signal)."""
    g, e = logits.shape
    probs = torch.softmax(logits.float(), dim=-1)
    vmask = (torch.ones(g, device=logits.device) if valid is None else valid.float())
    experts = torch.arange(e, device=logits.device)
    remaining = probs
    counts = torch.zeros(e, device=logits.device)
    gate_total = torch.zeros(g, device=logits.device)
    chosen, positions, kept, gates = [], [], [], []
    for _ in range(k):
        idx = remaining.argmax(dim=-1)
        gate = probs.gather(1, idx[:, None])[:, 0]
        # padding chooses nothing: its zeroed one-hot takes no position
        onehot = (idx[:, None] == experts).float() * vmask[:, None]
        pos_in_expert = onehot.cumsum(dim=0) - onehot + counts[None, :]
        pos = (pos_in_expert * onehot).sum(dim=-1)
        keep = (pos < capacity) & (vmask > 0)
        gate_total = gate_total + gate * keep
        counts = counts + onehot.sum(dim=0)
        remaining = remaining * (1.0 - onehot)
        chosen.append(idx)
        positions.append(pos.long())
        kept.append(keep)
        gates.append(gate * keep)
    # kept gates renormalised so each token's expert mix sums to 1
    weight = torch.stack(gates) / gate_total.clamp_min(1e-9)[None, :]
    n_valid = vmask.sum().clamp_min(1.0)
    frac = counts / counts.sum().clamp_min(1.0)
    mean_prob = (probs * vmask[:, None]).sum(dim=0) / n_valid
    aux = (frac * mean_prob).sum() * e
    return Routing(torch.stack(chosen), torch.stack(positions), torch.stack(kept), weight, aux)


def route_topk(logits: Tensor, k: int, capacity: int, valid: Optional[Tensor] = None
               ) -> tuple[Tensor, Tensor, Tensor]:
    """JAX's return form: (dispatch [G, E, C] bool, combine [G, E, C]
    float32, aux)."""
    g, e = logits.shape
    r = route(logits, k, capacity, valid)
    dispatch = torch.zeros((g, e, capacity), dtype=torch.bool, device=logits.device)
    combine = torch.zeros((g, e, capacity), device=logits.device)
    rows = torch.arange(g, device=logits.device)
    for j in range(k):
        sel = r.keep[j]
        dispatch[rows[sel], r.expert[j][sel], r.pos[j][sel]] = True
        combine[rows[sel], r.expert[j][sel], r.pos[j][sel]] = r.weight[j][sel]
    return dispatch, combine, r.aux


def route_tally(cfg: LlamaConfig, device) -> Optional[Tensor]:
    """An engine's routing tally ``[E + 2]`` (int64) for a MoE config: per
    expert the choices routed to it, then the choices dropped over
    capacity, then padding's; None for a llama config. Zero it in place: a
    CUDA graph captured with it adds into this tensor."""
    if not isinstance(cfg, MoeConfig):
        return None
    return torch.zeros(cfg.n_experts + 2, dtype=torch.int64, device=device)


def tally_stats(tally: Tensor) -> dict:
    """A tally as ``stats()`` keys: ``moe_routed`` (a count per expert),
    ``moe_dropped`` and ``moe_padding``."""
    counts = tally.tolist()
    return {"moe_routed": counts[:-2], "moe_dropped": counts[-2], "moe_padding": counts[-1]}


def _add_to_tally(tally: Tensor, r: Routing, valid: Optional[Tensor]) -> None:
    n_experts = tally.shape[0] - 2
    real = torch.ones_like(r.keep) if valid is None else valid[None, :].expand_as(r.keep)
    slot = torch.where(r.keep, r.expert, torch.where(real, n_experts, n_experts + 1))
    tally.index_add_(0, slot.reshape(-1), torch.ones_like(slot).reshape(-1))


def _capacity_experts(mp: dict, r: Routing, flat: Tensor, capacity: int,
                      dt: torch.dtype) -> Tensor:
    """Per-choice expert outputs [k, G, D] through ``[E, C, D]`` buffers;
    dropped choices read a zero row."""
    n_exp, d = mp["w_gate"].shape[0], flat.shape[1]
    k = r.expert.shape[0]
    dummy = n_exp * capacity
    slot = torch.where(r.keep, r.expert * capacity + r.pos, dummy)  # [k, G]
    buf = torch.zeros((dummy + 1, d), dtype=dt, device=flat.device)
    buf.index_copy_(0, slot.reshape(-1), flat.repeat(k, 1))
    xe = buf[:dummy].view(n_exp, capacity, d)
    h = F.silu(torch.bmm(xe, mp["w_gate"].to(dt))) * torch.bmm(xe, mp["w_up"].to(dt))
    y = torch.bmm(h, mp["w_down"].to(dt)).view(dummy, d)
    y = torch.cat([y, y.new_zeros(1, d)])
    return y[slot]


def _grouped_experts(mp: dict, r: Routing, flat: Tensor, dt: torch.dtype) -> Tensor:
    """Per-choice expert outputs [k, G, D], each expert multiplying only
    the kept choices routed to it; dropped choices are zero rows."""
    k, g = r.expert.shape
    n_exp, d = mp["w_gate"].shape[0], flat.shape[1]
    sel = r.keep.reshape(-1).nonzero()[:, 0]
    experts = r.expert.reshape(-1)[sel]
    order = torch.argsort(experts, stable=True)
    sel = sel[order]
    counts = torch.bincount(experts, minlength=n_exp).tolist()
    xs = flat[sel % g]
    ys = torch.empty_like(xs)
    start = 0
    for e, n in enumerate(counts):
        if n:
            seg = xs[start:start + n]
            h = F.silu(seg @ mp["w_gate"][e].to(dt)) * (seg @ mp["w_up"][e].to(dt))
            ys[start:start + n] = h @ mp["w_down"][e].to(dt)
            start += n
    out = torch.zeros((k * g, d), dtype=dt, device=flat.device)
    out[sel] = ys
    return out.view(k, g, d)


def moe_mlp(mp: dict, cfg: MoeConfig, x: Tensor, pad_mask: Optional[Tensor] = None,
            tally: Optional[Tensor] = None) -> tuple[Tensor, Tensor]:
    """Routed SwiGLU over x [B, T, D] → (out [B, T, D], aux scalar).
    ``pad_mask`` [B, T] keeps padding from taking expert capacity or
    skewing the load-balance statistics; the call's routing is added to
    ``tally`` (:func:`route_tally`) when one is given."""
    return _routed(mp["router"], cfg, x, pad_mask, tally,
                   lambda r, flat, capacity, by_capacity:
                   _experts(mp, r, flat, capacity, by_capacity, cfg.torch_dtype))


def ep_moe_mlp(shards: TPShards, layer: str, cfg: MoeConfig, x: Tensor,
               pad_mask: Optional[Tensor] = None, tally: Optional[Tensor] = None
               ) -> tuple[Tensor, Tensor]:
    """:func:`moe_mlp` over an ep × tp mesh (``shards.experts``: each ep
    coordinate's tp shards, ``MOE_EP_RULES``). The routing is computed once,
    from the replicated router on the first shard; each ep shard runs its
    ``E/ep`` experts' products on the choices routed to them (the others
    read zero rows), split over tp inside (each shard's ``w_gate`` /
    ``w_up`` columns and ``w_down`` rows); the partial outputs are summed
    over ep then tp in a fixed order on ``x``'s device, and combined there
    as :func:`moe_mlp` combines them."""

    def experts(r: Routing, flat: Tensor, capacity: int, by_capacity: bool) -> Tensor:
        parts = []
        for e, ep_shards in enumerate(shards.experts):
            n_local = ep_shards[0][layer]["moe"]["w_gate"].shape[0]
            lo = e * n_local
            mine = r.keep & (r.expert >= lo) & (r.expert < lo + n_local)
            for tree, dev in zip(ep_shards, ep_shards.devices):
                local = Routing(*(v.to(dev) for v in (r.expert - lo, r.pos, mine, r.weight)),
                                r.aux)
                parts.append(_experts(tree[layer]["moe"], local, flat.to(dev), capacity,
                                      by_capacity, cfg.torch_dtype))
        return psum(parts, x.device)

    return _routed(shards[0][layer]["moe"]["router"], cfg, x, pad_mask, tally, experts)


def _routed(router: dict, cfg: MoeConfig, x: Tensor, pad_mask: Optional[Tensor],
            tally: Optional[Tensor], experts) -> tuple[Tensor, Tensor]:
    """The routing and the combine around ``experts(routing, flat rows,
    capacity, by_capacity)`` → per-choice outputs [k, G, D]. Under CUDA
    graph capture the capacity buffers run whatever the call's size: the
    grouped rows read per-expert counts on the host."""
    dt = cfg.torch_dtype
    b, t, d = x.shape
    g = b * t
    flat = x.reshape(g, d).to(dt)
    capacity = expert_capacity(cfg, g)
    logits = L.dense(router, flat, torch.float32)  # [G, E]
    valid = None if pad_mask is None else pad_mask.reshape(g).to(flat.device)
    r = route(logits, cfg.experts_per_token, capacity, valid)
    if tally is not None:
        _add_to_tally(tally, r, valid)
    capturing = x.is_cuda and torch.cuda.is_current_stream_capturing()
    y = experts(r, flat, capacity, g <= CAPACITY_DISPATCH_ROWS or capturing)
    # JAX's combine: gates rounded to the compute dtype, summed in float32
    out = (r.weight.to(dt).float()[:, :, None] * y.float()).sum(dim=0).to(dt)
    return out.reshape(b, t, d), r.aux


def _experts(mp: dict, r: Routing, flat: Tensor, capacity: int, by_capacity: bool,
             dt: torch.dtype) -> Tensor:
    if by_capacity:
        return _capacity_experts(mp, r, flat, capacity, dt)
    return _grouped_experts(mp, r, flat, dt)


def moe_forward(params: dict, cfg: MoeConfig, ids: Tensor,
                positions: Optional[Tensor] = None, cache: Optional[Cache] = None,
                cache_index: Union[int, Tensor] = 0, pad_mask: Optional[Tensor] = None,
                attn_fn=None, logit_index: Optional[Tensor] = None,
                tally: Optional[Tensor] = None) -> tuple[Tensor, Optional[Cache], Tensor]:
    """ids [B, T] → (logits [B, T, vocab] float32, cache, the layers' summed
    aux loss): ``llama_forward``'s contract (``logit_index`` included) plus
    the router's aux scalar; every layer's routing goes into ``tally``.

    Expert parallel: ``params`` a :class:`TPShards` (``MOE_EP_RULES``) runs
    :func:`~.llama.tp_forward` with each layer's experts through
    :func:`ep_moe_mlp`."""
    if isinstance(params, TPShards):
        aux: list = []

        def experts(i: int, xm: Tensor) -> Tensor:
            out, layer_aux = ep_moe_mlp(params, f"layers_{i}", cfg, xm, pad_mask, tally)
            aux.append(layer_aux)
            return out

        logits, cache = tp_forward(params, cfg, ids, positions, cache, cache_index, pad_mask,
                                   attn_fn, logit_index, mlp=experts)
        return logits, cache, torch.stack(aux).sum()
    dt = cfg.torch_dtype
    b, t = ids.shape
    if positions is None:
        positions = torch.arange(t, device=ids.device)[None, :].expand(b, t)
    positions = positions.long()
    rope_len = cache["k"].shape[2] if cache is not None else max(t, cfg.max_len)
    cos, sin = L.rope_frequencies(cfg.head_dim, rope_len, cfg.rope_theta, ids.device)

    x = L.embed(params["embed_tokens"], ids, dt)
    aux_total = torch.zeros((), device=ids.device)
    for i in range(cfg.n_layers):
        lp = params[f"layers_{i}"]
        x = x + _attn(lp["attn"], cfg, L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps),
                      positions, cos, sin, i, cache, cache_index, pad_mask, attn_fn)
        routed, aux = moe_mlp(lp["moe"], cfg, L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps),
                              pad_mask, tally)
        x = x + routed
        aux_total = aux_total + aux
    if logit_index is not None:
        x = x[torch.arange(b, device=x.device), logit_index][:, None]
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = L.dense(params["lm_head"], x, dt)
    return logits.float(), cache, aux_total


def moe_serving_forward(params: dict, cfg: MoeConfig, ids: Tensor,
                        positions: Optional[Tensor] = None, cache: Optional[Cache] = None,
                        cache_index: Union[int, Tensor] = 0,
                        pad_mask: Optional[Tensor] = None, attn_fn=None,
                        logit_index: Optional[Tensor] = None, tally: Optional[Tensor] = None
                        ) -> tuple[Tensor, Optional[Cache]]:
    """``llama_forward``'s two-tuple contract: the aux loss is dropped."""
    logits, cache, _ = moe_forward(params, cfg, ids, positions, cache, cache_index, pad_mask,
                                   attn_fn, logit_index, tally)
    return logits, cache


def moe_loss(params, cfg: MoeConfig, ids: Tensor, mask: Tensor) -> Tensor:
    """Next-token cross-entropy plus ``router_aux_weight`` × the layers'
    summed aux: the ep train step's objective. The aux stays
    differentiable through the router's probabilities; both dispatch
    routes are differentiable (index copies and gathers). ``params`` a
    plain tree, a :class:`TPShards` or a
    :class:`~..parallel.sharding.ShardedParams`; the last routes the whole
    batch on its first data coordinate, since the capacity couples every
    token of the call (JAX routes the global batch; a split over dp would
    drop other choices)."""
    group = params.group(0) if isinstance(params, ShardedParams) else params
    dev = home_device(group)
    ids, mask = ids.to(dev), mask.to(dev)
    logits, _, aux = moe_forward(group, cfg, ids[:, :-1], pad_mask=mask[:, :-1])
    return weighted_mean([nll_sums(logits, ids, mask)], dev) + cfg.router_aux_weight * aux


def decoder_rules(cfg: LlamaConfig) -> Rules:
    """The sharding rules of a decoder config's family on a mesh, JAX's
    engines' ``default_rules``."""
    return MOE_EP_RULES if isinstance(cfg, MoeConfig) else LLAMA_TP_RULES


def tallied(forward_fn, tally: Optional[Tensor]):
    """``forward_fn`` adding its routing into ``tally`` where it is
    :func:`moe_serving_forward`; any other forward as it is."""
    if tally is None or forward_fn is not moe_serving_forward:
        return forward_fn
    return functools.partial(forward_fn, tally=tally)


# ------------------------------------------------------------ the family seam


def family(cfg: LlamaConfig) -> str:
    """A decoder config's family, as checkpoints and worker specs name it."""
    return "moe" if isinstance(cfg, MoeConfig) else "llama"


def decoder_config(model_family: str, fields: dict) -> LlamaConfig:
    """The inverse of :func:`family`: a family's name and its config's
    fields (a worker spec's) → the config."""
    return (MoeConfig if model_family == "moe" else LlamaConfig)(**fields)


def init_decoder(cfg: LlamaConfig, generator: torch.Generator, device,
                 dtype: Optional[torch.dtype] = None) -> dict:
    """Random weights of the config's family."""
    init = init_moe if isinstance(cfg, MoeConfig) else init_llama
    return init(cfg, generator, device, dtype)


def decoder_forward(cfg: LlamaConfig, forward_fn=None, explicit_params: bool = False):
    """The engines' family seam, as JAX's engines resolve it: no
    ``forward_fn`` picks the config's family; one of the two in-tree
    forwards must match it; any other needs parameters passed in (the
    default init builds the config family's tree)."""
    is_moe = isinstance(cfg, MoeConfig)
    if forward_fn is None:
        return moe_serving_forward if is_moe else llama_forward
    if forward_fn in (moe_serving_forward, llama_forward):
        if (forward_fn is moe_serving_forward) != is_moe:
            raise ValueError(f"forward_fn {forward_fn.__name__} does not match the "
                             f"{type(cfg).__name__} model family")
    elif not explicit_params:
        raise ValueError("forward_fn overrides the model family; pass matching params "
                         "explicitly (the default init builds the config family's tree)")
    return forward_fn
