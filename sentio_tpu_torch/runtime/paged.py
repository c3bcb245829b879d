"""Paged KV cache + continuous batching in PyTorch — the counterpart of
``sentio_tpu/runtime/paged.py`` with bf16 or int8 (``kv_quant="int8"``)
pools.

The device holds one pool of fixed-size pages ``[L, P, page, Hkv, D]``
(or, quantized, int8 codes of that shape plus f16 per-vector scales
``[L, P, page, Hkv]``: half the bytes to hold and to read at decode); every
live sequence owns a page table mapping its logical blocks to
physical pages. Requests join and leave decode slots without touching
anyone else's cache, and finishing one frees integer page ids. Page 0 is
a scratch page: free slots' tables point at it, and rows frozen inside a
tick write their KV there.

One engine tick (``step()``):

* **admission** — queued requests are tokenized, matched against the
  radix prefix cache (:mod:`.radix`; ``prefix_cache``), given pages (LRU
  eviction of unpinned cached prefixes when short, skip-ahead past a
  request too large for the free pages) and prefilled as batches grouped
  by suffix width, hits apart from cold rows. A hit prefills only the unmatched
  suffix over a dense cache primed from the matched pages; every prompt's
  full-page span is inserted back into the tree. With ``prefill_chunk`` a
  long suffix admits one segment per tick instead. The first token is
  sampled on the device and stays there;
* **one fused multi-step decode** — per-row budgets (token budget and
  page capacity, counting sub-steps still in flight), the admitted rows'
  first tokens merged into the device-carried decode state, then
  ``budgets.max()`` sub-steps over the slot batch with EOS halting and
  running logprob accumulators. On the card each sub-step is a replay of a
  captured CUDA graph; on the CPU the same function runs eagerly. The
  tick ends with one asynchronous copy of its tokens and logprob state to
  pinned host memory and an event;
* **harvest** — the host waits on that event, replays the halting rule to
  fold the tokens, and retires rows on EOS / length, freeing their pages.
  With ``pipeline_depth=2`` a tick's harvest waits until after the next
  tick is dispatched, so the host's work overlaps the device's (results
  lag one tick, as in JAX).

The pool is updated in place (the JAX engine donates its buffers to the
same effect). Decode attention goes through the paged kernel of the pool's
representation (:func:`sentio_tpu_torch.kernels.paged_attn_impl`), or
through the plain gather path when ``attn_impl`` is set to
``_paged_attn_xla``. Prefill keeps plain attention over the dense,
unquantized cache, as the JAX engine does: an int8 pool quantizes what is
written into its pages, so the first token is sampled from an unquantized
prefill (a prefix hit attends to the dequantized prior pages).

The parts the generation service (:mod:`.service`) drives are the JAX
engine's: per-request deadlines (``submit(deadline_ts=...)``: a request
still queued when its deadline passes comes back ``expired``), ``cancel``,
``reset`` after a failed tick, ``spawn_fresh`` (and ``release``, which
frees a replaced engine's memory before its successor allocates), the
fault points ``paged.step``, ``paged.admit_scatter`` and ``engine.reset``
(:mod:`sentio_tpu_torch.infra.faults`), ``ignore_eos``,
prior-token admission and per-request seeds (:func:`fold_seed`), the tick
ladder (``tick_step_sizes``, ``force_tick_steps``, ``pressure_hint``),
TTFT samples, and ``step()``'s split into the phases of
:mod:`sentio_tpu_torch.infra.phases`.

With a draft model (``draft_params``, ``draft_config``, ``spec_k``) every
decode tick is a spec tick (:mod:`.paged_spec`): draft-and-verify rounds
over the slot batch, each round one CUDA graph replay on the card, with the
draft prefilled over every admitted prompt. The decode state, the harvest
and retirement are the plain tick's. Device meshes are not ported.
"""

from __future__ import annotations

import contextlib
import hashlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.infra import faults
from sentio_tpu_torch.infra.phases import ENGINE_PHASES, PhaseTimer
from sentio_tpu_torch.kernels import KERNELS, paged_attn_impl
from sentio_tpu_torch.kernels._build import launch_tally
from sentio_tpu_torch.kernels.paged_attention import (
    QuantPages,
    paged_attention_plain,
    paged_attention_quant_plain,
)
from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.llama import LlamaConfig, init_cache, init_llama, llama_forward
from sentio_tpu_torch.models.tokenizer import ByteTokenizer
from sentio_tpu_torch.parallel.batcher import bucket_size
from sentio_tpu_torch.runtime.radix import RadixPrefixCache
from sentio_tpu_torch.runtime.sampling import sample_tokens

Tensor = torch.Tensor
Pages = Union[Tensor, QuantPages]  # a pool's k or v, or one layer of it

# one card, several engines (the replica tier): a graph capture and the
# release of a rebuilt engine's memory take this lock. ``torch.cuda.graph``
# synchronizes the device and empties the allocator's cache before it
# begins, and neither may run while another thread's capture is open.
CAPTURE_LOCK = threading.Lock()


def fold_seed(generator: torch.Generator, seed: int) -> None:
    """Reseed ``generator`` from its current state and ``seed`` — JAX's
    ``fold_in`` of a request's seed into the engine key: engines in the same
    state draw alike for one seed, and a repeat draws anew."""
    state = generator.get_state().numpy().tobytes()
    digest = hashlib.blake2b(state + int(seed).to_bytes(8, "little", signed=True),
                             digest_size=8).digest()
    generator.manual_seed(int.from_bytes(digest, "little") & 0x7FFF_FFFF_FFFF_FFFF)


# --------------------------------------------------------------------- pool


@dataclass
class PagedPool:
    """Device page pool: k/v ``[L, P, page, Hkv, D]`` in the model dtype, or
    :class:`QuantPages` (int8 codes of that shape, f16 scales ``[L, P, page,
    Hkv]``). Page id 0 = scratch."""

    k: Pages
    v: Pages
    page_size: int

    @property
    def quantized(self) -> bool:
        return isinstance(self.k, QuantPages)

    @property
    def hbm_bytes(self) -> int:
        """Device bytes of the k+v pools, payload plus scales."""
        leaves = (*self.k, *self.v) if self.quantized else (self.k, self.v)
        return sum(t.numel() * t.element_size() for t in leaves)


def init_pool(cfg: LlamaConfig, num_pages: int, page_size: int, device,
              quantized: bool = False) -> PagedPool:
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads, cfg.head_dim)

    def pages() -> Pages:
        if quantized:
            return QuantPages(q=torch.zeros(shape, dtype=torch.int8, device=device),
                              s=torch.zeros(shape[:-1], dtype=torch.float16, device=device))
        return torch.zeros(shape, dtype=cfg.torch_dtype, device=device)

    return PagedPool(k=pages(), v=pages(), page_size=page_size)


def quantize_kv(x: Tensor) -> tuple[Tensor, Tensor]:
    """[..., D] float → (int8 [..., D], f16 scale [...]): symmetric absmax per
    vector, a copy of the JAX ``quantize_kv``. The codes come from the
    float32 scale (only the stored scale is cast to f16), and ``torch.round``
    rounds half to even as ``jnp.round`` does, so the same float inputs give
    bit-identical codes and scales. A zero vector gets scale 0 and
    dequantizes to exact zeros."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / scale.clamp_min(1e-8)[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.to(torch.float16)


def dequantize_kv(q: Tensor, scale: Tensor, dtype: torch.dtype) -> Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _page_write(pages: Pages, layer: int, page_ids: Tensor, offsets: Tensor,
                val: Tensor) -> None:
    """Write val [B, Hkv, D] at (layer, page_ids[b], offsets[b]) per row, in
    place, quantizing for an int8 pool."""
    if isinstance(pages, QuantPages):
        q, s = quantize_kv(val)
        pages.q[layer, page_ids, offsets] = q
        pages.s[layer, page_ids, offsets] = s
    else:
        pages[layer, page_ids, offsets] = val


def _layer_pages(pages: Pages, layer: int) -> Pages:
    """One layer's pages, a view (contiguous, no copy)."""
    if isinstance(pages, QuantPages):
        return QuantPages(pages.q[layer], pages.s[layer])
    return pages[layer]


def _page_dim(pages: Pages) -> int:
    return (pages.q if isinstance(pages, QuantPages) else pages).shape[-3]


def _gather_prior(pages: Pages, table: Tensor, dtype: torch.dtype) -> Tensor:
    """Every layer's pages of ``table`` [B, NB] as a dense [L, B, NB*page,
    Hkv, D] in ``dtype``, dequantized from an int8 pool."""
    if isinstance(pages, QuantPages):
        dense = dequantize_kv(pages.q[:, table], pages.s[:, table], dtype)
    else:
        dense = pages[:, table]
    lcount, b, nb, page, hkv, hd = dense.shape
    return dense.reshape(lcount, b, nb * page, hkv, hd)


class PageAllocator:
    """Host free-list over page ids 1..P-1 (0 is the shared scratch page)."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved scratch)")
        self._free: list[int] = list(range(num_pages - 1, 0, -1))
        self.num_pages = num_pages

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"paged KV pool exhausted: need {n}, have {len(self._free)}")
        return [self._free.pop() for _ in range(n)]

    def free(self, ids: Sequence[int]) -> None:
        self._free.extend(pid for pid in ids if pid != 0)


# ------------------------------------------------------------ device steps


def _paged_attn_xla(q, k_pages_l, v_pages_l, page_table, lens, n_rep):
    """Decode attention over a page table by the plain gather path (an int8
    pool is gathered and dequantized) — the counterpart of the JAX engine's
    XLA fallback and the reference the kernels are held against. Same
    signature as ``paged_attn_impl``."""
    if isinstance(k_pages_l, QuantPages):
        out = paged_attention_quant_plain(q[:, 0], k_pages_l.q, k_pages_l.s,
                                          v_pages_l.q, v_pages_l.s, page_table, lens)
    else:
        out = paged_attention_plain(q[:, 0], k_pages_l, v_pages_l, page_table, lens)
    return out[:, None]


def paged_decode_forward(params: dict, cfg: LlamaConfig, tok: Tensor, lens: Tensor,
                         page_table: Tensor, k_pages: Pages, v_pages: Pages,
                         attn_impl=None, write_mask: Optional[Tensor] = None,
                         rope: Optional[tuple[Tensor, Tensor]] = None) -> Tensor:
    """One decode step over the paged pool → logits [B, V] float32.

    tok [B] (last sampled token per slot); lens [B] int32, the absolute
    position the new token occupies; page_table [B, NB] int32. This step's
    k/v are written into each row's current page in place before attention
    reads them (quantized first for an int8 pool). ``write_mask`` [B] bool
    redirects masked rows' writes to the
    scratch page, freezing rows that hit EOS or their budget mid-tick.
    ``rope`` is the (cos, sin) table pair covering the window; the engine
    builds it once, so a captured sub-step reads a static tensor."""
    dt = cfg.torch_dtype
    b = tok.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    page = _page_dim(k_pages)
    nb = page_table.shape[1]
    positions = lens.long()[:, None]  # [B, 1]
    cos, sin = rope or L.rope_frequencies(hd, max(nb * page, cfg.max_len), cfg.rope_theta,
                                          tok.device)

    block = (lens.long() // page).clamp_max(nb - 1)
    page_ids = page_table.long().gather(1, block[:, None])[:, 0]
    offsets = lens.long() % page
    if write_mask is not None:
        page_ids = torch.where(write_mask, page_ids, 0)
        offsets = torch.where(write_mask, offsets, 0)

    impl = attn_impl or _paged_attn_xla
    x = L.embed(params["embed_tokens"], tok[:, None], dt)  # [B, 1, dim]
    for i in range(cfg.n_layers):
        lp = params[f"layers_{i}"]
        xn = L.rmsnorm(lp["attn_norm"], x, cfg.norm_eps)
        q = L.dense(lp["attn"]["wq"], xn, dt).reshape(b, 1, h, hd)
        k = L.dense(lp["attn"]["wk"], xn, dt).reshape(b, 1, hkv, hd)
        v = L.dense(lp["attn"]["wv"], xn, dt).reshape(b, 1, hkv, hd)
        q = L.apply_rope(q, positions, cos, sin)
        k = L.apply_rope(k, positions, cos, sin)
        _page_write(k_pages, i, page_ids, offsets, k[:, 0].to(dt))
        _page_write(v_pages, i, page_ids, offsets, v[:, 0].to(dt))

        out = impl(q, _layer_pages(k_pages, i), _layer_pages(v_pages, i), page_table, lens,
                   h // hkv)
        x = x + L.dense(lp["attn"]["wo"], out.reshape(b, 1, cfg.dim), dt)
        xm = L.rmsnorm(lp["mlp_norm"], x, cfg.norm_eps)
        gate = torch.nn.functional.silu(L.dense(lp["mlp"]["w_gate"], xm, dt))
        x = x + L.dense(lp["mlp"]["w_down"], gate * L.dense(lp["mlp"]["w_up"], xm, dt), dt)

    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.dense(params["lm_head"], x, dt)[:, 0].float()


def scatter_prefill(k_pages: Pages, v_pages: Pages, k_cache: Tensor,
                    v_cache: Tensor, page_table: Tensor) -> None:
    """Copy a contiguous prefill cache into the pool, in place, quantizing
    it for an int8 pool.

    k/v_cache [L, B, S, Hkv, D] (S a multiple of the page size), page_table
    [B, S/page]. Blocks past a row's prompt map to scratch page 0."""
    lcount, b, s, hkv, hd = k_cache.shape
    page = _page_dim(k_pages)
    table = page_table.long()
    for pages, cache in ((k_pages, k_cache), (v_pages, v_cache)):
        blocks = cache.reshape(lcount, b, s // page, page, hkv, hd)
        if isinstance(pages, QuantPages):
            q, scale = quantize_kv(blocks)
            pages.q[:, table] = q
            pages.s[:, table] = scale
        else:
            pages[:, table] = blocks


# ---------------------------------------------------------------- the engine


@dataclass
class _Slot:
    request_id: int = -1
    pages: list[int] = field(default_factory=list)  # own pages, after the shared ones
    length: int = 0          # tokens currently in cache (prompt + generated)
    prompt_tokens: int = 0
    max_new: int = 0
    temperature: float = 0.0
    top_k: int = 0
    emitted: list[int] = field(default_factory=list)
    active: bool = False
    # the first sampled token is still on the device (admission does not
    # fetch it; the next tick's packed output brings it to the host)
    pending_first: bool = False
    # decode sub-steps granted to dispatched, unharvested ticks: the budget
    # counts them, or a pipelined tick would run past the limits
    inflight_steps: int = 0
    # tokens served from shared, read-only prefix-cache pages at the front
    # of this slot's page table: counted in capacity, never freed by retire
    shared_tokens: int = 0
    # the radix node chain this slot pins, its truncated prompt ids (the
    # insert key once the prompt KV is written) and the own pages whose
    # ownership moved to the cache (retire must not free them)
    prefix_node: object = None
    prompt_ids: Optional[list] = None
    donated: list = field(default_factory=list)
    submit_t: float = 0.0
    # chunked prefill: suffix tokens not yet written, and how many own
    # tokens already are; while prefill_todo is set the slot holds pages
    # but takes no decode budget
    prefill_todo: Optional[list] = None
    prefill_done: int = 0


@dataclass
class _Request:
    request_id: int
    prompt: str
    max_new: int
    temperature: float
    top_k: int = 0
    submit_t: float = 0.0
    # absolute time.perf_counter() deadline (None = none): a request still
    # queued when it passes is dropped before its prefill
    deadline_ts: Optional[float] = None
    # tokenized once: skip-ahead may look at a queued request many times
    tok_ids: Optional[list] = None
    # token ids admitted after the truncated prompt as context already
    # generated; the truncation reserve counts them as if they were part
    # of max_new, so the prompt truncates as it would without them
    prior_tokens: Optional[list] = None
    # per-request seed, folded into the engine's generator once, at the
    # first admission scan (fold_seed)
    seed: Optional[int] = None


@dataclass
class PagedResult:
    request_id: int
    text: str
    tokens: list[int]
    prompt_tokens: int
    finish_reason: str  # "stop" | "length" | "cancelled" | "expired" | "error"
    # prompt tokens forwarded at admission vs served from the radix prefix
    # cache (prefill_tokens + prefix_hit_tokens == prompt_tokens)
    prefill_tokens: int = 0
    prefix_hit_tokens: int = 0
    # sampled-token logprob accumulators (sum / min / count over every token
    # this request sampled, EOS included)
    logprob_sum: float = 0.0
    logprob_min: float = 0.0
    logprob_count: int = 0
    # the replica whose service finished it (-1: a bare engine)
    replica_id: int = -1

    @property
    def logprob_mean(self) -> Optional[float]:
        if self.logprob_count <= 0:
            return None
        return self.logprob_sum / self.logprob_count

    def stats_dict(self) -> dict:
        out = {
            "logprob_sum": self.logprob_sum,
            "logprob_min": self.logprob_min,
            "logprob_count": self.logprob_count,
            "logprob_mean": self.logprob_mean,
            "tokens": len(self.tokens),
            "finish_reason": self.finish_reason,
        }
        if self.replica_id >= 0:
            out["replica_id"] = self.replica_id
        return out


class _DecodeState:
    """The decode state carried on the device from tick to tick (the JAX
    engine's ``_dev_state``) and the tick's inputs, in buffers that never
    move: a decode sub-step reads and updates them in place, so one CUDA
    graph of it replays against the same addresses every tick."""

    def __init__(self, max_slots: int, max_pages_per_seq: int, max_steps: int,
                 device) -> None:
        def zeros(*shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tok = zeros(max_slots, dtype=torch.int64)
        self.lens = zeros(max_slots, dtype=torch.int32)
        self.halted = zeros(max_slots, dtype=torch.bool)
        self.lp_sum = zeros(max_slots, dtype=torch.float32)
        self.lp_min = zeros(max_slots, dtype=torch.float32)
        self.lp_cnt = zeros(max_slots, dtype=torch.int32)
        self.table = zeros(max_slots, max_pages_per_seq, dtype=torch.int32)
        self.budgets = zeros(max_slots, dtype=torch.int32)
        self.temps = zeros(max_slots, dtype=torch.float32)
        self.top_ks = zeros(max_slots, dtype=torch.int64)
        self.idx = zeros(1, dtype=torch.int64)  # the sub-step within the tick
        # row 0 echoes the tick's input tokens, row 1 + s is sub-step s's
        self.packed = zeros(1 + max_steps, max_slots, dtype=torch.int64)


class ContinuousBatchingEngine:
    """Slot-based continuous batching over the paged pool.

    ``max_slots`` decode lanes run one fused multi-step tick per ``step()``;
    requests are admitted into free lanes in arrival order (skipping ahead
    of one too large for the free pages at most ``head_skip_bound`` times)
    and retired on EOS / length. ``attn_impl`` is the decode-attention
    seam: the paged kernel by default, the plain gather path
    (``_paged_attn_xla``) when set to it. ``kv_quant="int8"`` stores the
    pool as int8 codes plus f16 scales (``KV_QUANT``), which routes decode
    to the int8 kernel. ``prefix_cache`` (``PREFIX_CACHE``),
    ``pipeline_depth`` (``DECODE_PIPELINE_DEPTH``, 1 or 2) and
    ``prefill_chunk`` (``PREFILL_CHUNK``, a multiple of the page size)
    behave as in the JAX engine. ``cuda_graphs`` (on for a CUDA device)
    runs each decode sub-step as a CUDA graph replay; turning it off runs
    the same sub-step eagerly, which is how the graphs are held to it.
    A draft model (``draft_params``, ``draft_config``; ``spec_k`` drafted
    tokens a round, ``LLM_DRAFT_CHECKPOINT`` / ``SPECULATIVE_K``) makes every
    decode tick a spec tick (:mod:`.paged_spec`; each round a graph replay
    on the card), and ``top_k`` is then refused. Single-threaded: one
    caller drives ``step()``. On the card the engine's device work runs on
    its own stream (``stream``, :meth:`on_stream`) and its graphs live in
    its own graph pool, so several engines (replicas) can share the card."""

    PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
    ADMIT_BUCKETS = (1, 2, 4, 8)
    # the sampling variants a tick can ask for, (all rows greedy, some row
    # with top-k): a greedy batch ignores top-k, so (True, True) is never
    # asked for and three graphs cover every tick
    GRAPH_VARIANTS = ((True, False), (False, False), (False, True))
    # a spec round's variants, ("spec", all rows greedy): top-k is refused
    SPEC_GRAPH_VARIANTS = (("spec", True), ("spec", False))
    # transient f32 score bytes one prefill dispatch may materialize
    # ([rows, H, W, prior + W] in plain attention); wider batches prefill in
    # parts
    PREFILL_SCORE_BYTES = 2 << 30

    def __init__(
        self,
        model_config: Optional[LlamaConfig] = None,
        params: Optional[dict] = None,
        max_slots: int = 8,
        page_size: int = 16,
        num_pages: Optional[int] = None,
        max_pages_per_seq: int = 16,
        rng_seed: int = 0,
        steps_per_tick: int = 8,
        max_tick_steps: Optional[int] = None,
        ignore_eos: bool = False,
        pipeline_depth: int = 1,
        kv_quant: str = "none",
        prefill_chunk: Optional[int] = None,
        prefix_cache: bool = True,
        draft_params: Optional[dict] = None,
        draft_config: Optional[LlamaConfig] = None,
        spec_k: int = 4,
        device=None,
    ) -> None:
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
        if prefill_chunk is not None:
            prefill_chunk = int(prefill_chunk)
            if prefill_chunk <= 0 or prefill_chunk % page_size:
                raise ValueError(f"prefill_chunk must be a positive multiple of page_size "
                                 f"({page_size}), got {prefill_chunk}")
        self.device = resolve_device(device)
        # the engine's own CUDA stream: its ticks, prefills, warmup and graph
        # captures all run on it (on_stream()), so engines sharing the card
        # (replicas) never meet on the legacy default stream, and its device
        # buffers are allocated on it; it first waits for the caller's work
        # (the weights)
        self.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.cfg = model_config or LlamaConfig.tiny()
        # paged speculation (runtime/paged_spec.py): a draft turns every
        # decode tick into draft/verify/accept rounds
        self.draft_params = None
        self.draft_cfg = draft_config
        self.spec_k = max(int(spec_k), 1)
        if draft_params is not None:
            if draft_config is None:
                raise ValueError("draft_params requires draft_config")
            if prefill_chunk is not None:
                raise ValueError("paged speculation and chunked prefill are mutually "
                                 "exclusive (the draft prefills whole prompts)")
            if draft_config.vocab_size != self.cfg.vocab_size:
                raise ValueError(f"draft vocab {draft_config.vocab_size} != target "
                                 f"vocab {self.cfg.vocab_size}")
            self.draft_params = draft_params
        self.tokenizer = ByteTokenizer(self.cfg.vocab_size)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed + 1)
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(rng_seed)
            with self.on_stream():
                params = init_llama(self.cfg, init_gen, self.device)
        self.params = params
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.steps_per_tick = max(int(steps_per_tick), 1)
        self.max_tick_steps = (max(int(max_tick_steps), self.steps_per_tick)
                               if max_tick_steps is not None else self.steps_per_tick)
        # fixed-length generation (benchmarks): EOS neither halts a row nor
        # retires it
        self.ignore_eos = bool(ignore_eos)
        self.pipeline_depth = min(max(int(pipeline_depth), 1), 2)
        self.prefill_chunk = prefill_chunk
        if num_pages is None:
            num_pages = 1 + max_slots * max_pages_per_seq
        self.kv_quant = kv_quant
        with self.on_stream():
            self.pool = init_pool(self.cfg, num_pages, page_size, self.device,
                                  quantized=kv_quant == "int8")
        self.allocator = PageAllocator(num_pages)
        self._prefix_cache_enabled = bool(prefix_cache)
        self._radix = RadixPrefixCache(page_size, self.allocator) if prefix_cache else None
        self.attn_impl = paged_attn_impl
        self.cuda_graphs = self.device.type == "cuda"

        self.slots = [_Slot() for _ in range(max_slots)]
        self._queue: list[_Request] = []
        self._finished: list[PagedResult] = []
        self._next_id = itertools.count()
        # skip-ahead: a request too large for the free pages may be jumped
        # by later ones, but only head_skip_bound times; then the head is
        # strict FIFO again until its pages free
        self.head_skip_bound = 16
        self._head_skips = 0
        # rows that shared the last decode tick (budget > 0 or a first token
        # folded by it)
        self.last_tick_active = 0
        # seconds per phase of the last step() (infra/phases.py); the
        # service adds its own inbox_drain / deliver sections
        self._phase = PhaseTimer(ENGINE_PHASES)
        self.last_step_phases: dict = dict.fromkeys(ENGINE_PHASES, 0.0)
        # submit() → first token visible on the host, seconds
        self.ttft_samples: deque = deque(maxlen=1024)
        self.ttft_count = 0
        # set by the service: how many callers wait upstream of the queue,
        # so ticks stay short while they do
        self.pressure_hint = None
        # pins the next ticks' length to one rung of tick_step_sizes()
        # (the service's warmup); ignored for any other value
        self.force_tick_steps: Optional[int] = None
        # decode sub-steps run on the device, fully masked ones included
        # (a graph's warmup before its capture is one)
        self.total_sub_steps = 0
        self.prefill_tokens_total = 0
        self.decode_tokens_total = 0
        # admissions against a non-empty cache that hit / missed it, and the
        # prompt tokens served from it / forwarded
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_hit_tokens_total = 0
        self.prefix_miss_tokens_total = 0
        # spec ticks: tokens emitted and verifies run per row (their ratio is
        # tokens per verify), and rounds run over the slot batch
        self.spec_emitted_total = 0
        self.spec_verifies_total = 0
        self.spec_rounds_total = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self.graph_capture_s = 0.0
        # set by the service's warmup once every variant of GRAPH_VARIANTS
        # is captured: a tick that would capture another is an error
        self.graphs_frozen = False
        # (first tokens, their logprobs) on the device per admission
        # dispatch, with their slots and those slots' request ids; merged
        # into the decode state by the next tick
        self._pending_first: list[tuple[Tensor, Tensor, list[int], list[int]]] = []
        self._inflight: Optional[dict] = None  # the unharvested tick at depth 2
        # lanes retired since the last dispatch: their device lens go back
        # to 0 so an idle lane's attention reads one key of scratch page 0
        self._stale_lanes: set[int] = set()
        # host mirrors of per-slot decode state
        self._page_table = np.zeros((max_slots, max_pages_per_seq), np.int32)
        self._temps = np.zeros(max_slots, np.float32)
        self._top_ks = np.zeros(max_slots, np.int64)
        self._last_tok = np.zeros(max_slots, np.int64)
        self._lp_sum = np.zeros(max_slots, np.float32)
        self._lp_min = np.zeros(max_slots, np.float32)
        self._lp_cnt = np.zeros(max_slots, np.int32)

        with self.on_stream():
            self._st = _DecodeState(max_slots, max_pages_per_seq, self.max_tick_steps,
                                    self.device)
            self._rope = L.rope_frequencies(
                self.cfg.head_dim, max(max_pages_per_seq * page_size, self.cfg.max_len),
                self.cfg.rope_theta, self.device)
        # one CUDA graph per sampling variant, captured on first use into
        # one shared memory pool, with each graph's launches per kernel
        self._graphs: dict[tuple, tuple] = {}
        self._graph_pool = None
        # the spec tick's buffers (dense target cache, draft cache), made at
        # the first admission; the host's copy of the rows' done flags
        self._spec = None
        self._done_host: Optional[Tensor] = None

    # --------------------------------------------------------------- public

    def submit(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0,
               deadline_ts: Optional[float] = None, top_k: int = 0,
               prior_tokens: Optional[Sequence[int]] = None,
               seed: Optional[int] = None) -> int:
        """Queue a request. ``deadline_ts`` is an absolute
        ``time.perf_counter()`` deadline: a request still waiting for a slot
        when it passes comes back with ``finish_reason="expired"``. ``top_k``
        (0 = off) is per request, carried by every sampling call of its row.
        ``prior_tokens`` are token ids admitted after the prompt as context
        already generated; only tokens after them are emitted. ``seed``
        (None = off) reseeds the engine's generator at admission. With a
        draft, ``top_k > 0`` raises ``ValueError``."""
        if top_k > 0 and self.draft_params is not None:
            raise ValueError("top_k sampling is not supported with paged speculation "
                             "(the spec tick's accept/correct rule is temperature-only)")
        rid = next(self._next_id)
        self._queue.append(_Request(
            rid, prompt, max_new_tokens, temperature, top_k=max(int(top_k), 0),
            submit_t=time.perf_counter(), deadline_ts=deadline_ts,
            prior_tokens=list(prior_tokens) if prior_tokens else None, seed=seed))
        return rid

    def warm_prefix(self, text: str) -> int:
        """Put ``text``'s full-page KV into the radix cache, so even the
        first request that starts with it prefills only its suffix. Returns
        the tokens now cached (0 with the cache off, for a text shorter than
        a page, or when live slots pin the pool). Warmed nodes are unpinned:
        eviction reclaims them like any other cached prefix."""
        if self._radix is None:
            return 0
        toks = self.tokenizer.encode(text, add_bos=True)
        # leave at least one page of table room for suffix + decode
        n_blocks = min(len(toks) // self.page_size, self.max_pages_per_seq - 1)
        if n_blocks <= 0:
            return 0
        full = n_blocks * self.page_size
        matched, _pages, _node = self._radix.match(toks[:full])
        if matched >= full:
            return full
        need = (full - matched) // self.page_size
        if need > self.allocator.free_pages:
            self._radix.evict(need - self.allocator.free_pages)
            matched, _pages, _node = self._radix.match(toks[:full])
            need = (full - matched) // self.page_size
            if need > self.allocator.free_pages:
                return 0
        pages = self.allocator.alloc(need)
        # prefill the whole span cold and scatter only the uncovered blocks
        # (cached blocks go to scratch page 0); nothing is sampled
        with self.on_stream():
            self._prefill_rows(self._prefill_width(full), 0,
                               [(toks[:full], 0.0, 0, [0] * (matched // self.page_size) + pages)],
                               [0], None, do_sample=False)
        _node, donated = self._radix.insert(toks[:full], matched, pages)
        leftover = set(pages) - set(donated)
        if leftover:
            self.allocator.free(list(leftover))
        return full

    def peek_prefix(self, tok_ids: Sequence[int]) -> int:
        """How many leading tokens of ``tok_ids`` the radix cache could
        serve, clamped as admission clamps a match (one suffix token must
        remain). Takes no refcounts and touches no LRU state."""
        if self._radix is None or not tok_ids:
            return 0
        matched = self._radix.peek_prefix(tok_ids)
        max_shared = ((len(tok_ids) - 1) // self.page_size) * self.page_size
        return max(min(matched, max_shared), 0)

    def cancel(self, request_id: int) -> bool:
        """Abandon a request: queued → dropped; admitted → its slot retires
        ``"cancelled"`` and frees its pages (the tokens so far are
        dropped). Returns whether the request was found."""
        for idx, req in enumerate(self._queue):
            if req.request_id == request_id:
                del self._queue[idx]
                if idx == 0:
                    # the skip budget belongs to the departed head
                    self._head_skips = 0
                return True
        for i, slot in enumerate(self.slots):
            if slot.active and slot.request_id == request_id:
                self._retire(i, "cancelled")
                return True
        return False

    def reset(self) -> None:
        """Rebuild the decode state after a failed tick: queued and admitted
        requests are dropped (the service already answered their callers),
        the pool, the allocator, the radix tree, the decode state and the
        spec tick's caches are cleared, and the generator is reseeded. They
        are zeroed in place, so the weights and the captured graphs, which
        hold their addresses, are kept."""
        # chaos seam: lets a drill make the reset itself fail (the path that
        # latches a service broken and quarantines its replica)
        faults.hit("engine.reset")
        with self.on_stream():
            for pages in (self.pool.k, self.pool.v):
                for t in (pages if isinstance(pages, QuantPages) else (pages,)):
                    t.zero_()
        self.allocator = PageAllocator(self.allocator.num_pages)
        self.slots = [_Slot() for _ in range(self.max_slots)]
        self._queue.clear()
        self._head_skips = 0
        self._finished.clear()
        self._pending_first.clear()
        self._inflight = None
        self._stale_lanes.clear()
        if self._prefix_cache_enabled:
            self._radix = RadixPrefixCache(self.page_size, self.allocator)
        for arr in (self._page_table, self._temps, self._top_ks, self._last_tok,
                    self._lp_sum, self._lp_min, self._lp_cnt):
            arr[:] = 0
        with self.on_stream():
            for t in vars(self._st).values():
                t.zero_()
            if self._spec is not None:
                self._spec.zero_()
        self._gen.manual_seed(int(np.random.default_rng().integers(2**31)))

    def spawn_fresh(self) -> "ContinuousBatchingEngine":
        """A new engine sharing only this one's weights and settings: its
        own pool, allocator, radix tree, slots and graphs."""
        return ContinuousBatchingEngine(
            model_config=self.cfg, params=self.params, max_slots=self.max_slots,
            page_size=self.page_size, num_pages=self.allocator.num_pages,
            max_pages_per_seq=self.max_pages_per_seq, steps_per_tick=self.steps_per_tick,
            max_tick_steps=self.max_tick_steps, ignore_eos=self.ignore_eos,
            pipeline_depth=self.pipeline_depth, kv_quant=self.kv_quant,
            prefill_chunk=self.prefill_chunk, prefix_cache=self._prefix_cache_enabled,
            draft_params=self.draft_params, draft_config=self.draft_cfg, spec_k=self.spec_k,
            device=self.device,
        )

    def release(self) -> None:
        """Free this engine's device memory — the pool, the decode state,
        the graphs and their pool, the spec tick's caches — once nothing
        will drive it again. A rebuilt replica's old incarnation calls it
        before the fresh engine allocates, so the card never holds both
        pools; the weights are shared and stay. The engine is unusable
        afterwards."""
        if self.stream is not None:
            self.stream.synchronize()
        self.pool = self._st = self._rope = self._spec = self._done_host = None
        self._graphs.clear()
        self._graph_pool = None
        self._pending_first.clear()
        self._inflight = None
        self.trim_cache()

    def trim_cache(self) -> None:
        """Return the caching allocator's unused blocks to the card (each
        engine's stream keeps its own, which no other stream reuses), under
        the capture lock; a rebuild calls it before the fresh engine
        allocates."""
        if self.device.type == "cuda":
            with CAPTURE_LOCK:
                torch.cuda.empty_cache()

    def on_stream(self):
        """The context this engine's device work runs in: its own stream on
        the card, nothing on the CPU. ``step``, ``warm_prefix``, ``reset``,
        ``prefill_forward`` and ``decode_forward`` enter it themselves."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def partial_step_phases(self) -> dict:
        """The current step's phase seconds so far: what a step that raised
        spent (``last_step_phases`` still holds the step before)."""
        return dict(self._phase.acc)

    def prefill_shapes(self) -> tuple[list[int], list[int]]:
        """The prefill widths admission can choose, and the JAX engine's
        prior-page buckets (powers of two up to the window): the shapes the
        service's warmup admits once each. The port compiles nothing per
        shape; these admissions take each shape's first allocations out of
        the first requests."""
        window = self.max_pages_per_seq * self.page_size
        # reserve = min(max_new + 2, window // 2) >= 3 tokens
        widths = sorted({self._prefill_width(n) for n in range(1, max(window - 3, 1) + 1)})
        priors = sorted({min(1 << (n - 1).bit_length(), self.max_pages_per_seq)
                         for n in range(1, self.max_pages_per_seq)})
        return widths, priors

    def tick_step_sizes(self) -> tuple[int, ...]:
        """Every tick length ``_dispatch_tick`` can choose: the idle queue's
        big tick and the three rungs of the pressure ladder."""
        sizes = {self.max_tick_steps}
        for shrink in (1, 2, 4):
            sizes.add(max(self.steps_per_tick // shrink, 2))
        return tuple(sorted(sizes))

    @property
    def graph_variants(self) -> tuple:
        """The CUDA graphs this engine's ticks can ask for: the decode
        sub-step's sampling variants, or with a draft the spec round's."""
        return self.SPEC_GRAPH_VARIANTS if self.draft_params is not None \
            else self.GRAPH_VARIANTS

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s.active for s in self.slots) \
            or self._inflight is not None

    def run_all(self, prompts: Sequence[str], max_new_tokens: int = 64,
                temperature: float = 0.0) -> list[PagedResult]:
        """Submit-and-drain convenience."""
        ids = [self.submit(p, max_new_tokens, temperature) for p in prompts]
        done: dict[int, PagedResult] = {}
        while self.has_work:
            for r in self.step():
                done[r.request_id] = r
        return [done[i] for i in ids]

    def step(self) -> list[PagedResult]:
        """One tick: admit waiting requests (their prefill dispatches do not
        wait), advance one chunked-prefill segment, dispatch one fused
        decode tick, harvest. At ``pipeline_depth`` 2 the harvest is of the
        previous tick, after this one is dispatched. Returns the results
        completed this tick; ``last_step_phases`` holds its seconds by
        phase."""
        with self.on_stream():
            return self._step()

    def _step(self) -> list[PagedResult]:
        acc = self._phase.acc
        # the timer resets before the injection point, so a failed step's
        # partial phases belong to it alone
        self._phase.reset()
        # chaos seam: a raised fault propagates as a failed device dispatch
        # would (the service resets and requeues); a stall wedges the pump
        faults.hit("paged.step")
        t0 = time.perf_counter()
        self.last_tick_active = 0
        self._admit()
        if self.prefill_chunk is not None:
            self._advance_prefill()
        t_admit = time.perf_counter()
        acc["admission_build"] += (t_admit - t0) - acc["prefill_dispatch"]
        record = self._dispatch_tick() if any(s.active for s in self.slots) else None
        t_dispatch = time.perf_counter()
        acc["decode_dispatch"] += (t_dispatch - t_admit) - acc["device_wait"]
        # results of retires made while budgeting ride this step's return
        out, self._finished = self._finished, []
        if self.pipeline_depth <= 1:
            if record is not None:
                out.extend(self._harvest(record))
        else:
            prev, self._inflight = self._inflight, record
            if prev is not None:
                out.extend(self._harvest(prev))
        t_harvest = time.perf_counter()
        # the harvest waits on its tick's event: at depth 2 that tick was
        # dispatched one step earlier, but this is where the wall clock goes
        acc["device_wait"] += t_harvest - t_dispatch
        acc["other"] += time.perf_counter() - t_harvest
        self.last_step_phases = dict(acc)
        return out

    def stats(self) -> dict:
        out = {
            "active_slots": sum(s.active for s in self.slots),
            "max_slots": self.max_slots,
            "queued": len(self._queue),
            "free_pages": self.allocator.free_pages,
            "total_pages": self.allocator.num_pages,
            "page_size": self.page_size,
            "kv_quant": self.kv_quant,
            "pool_hbm_bytes": self.pool.hbm_bytes if self.pool is not None else 0,
            "head_skips": self._head_skips,
            "ttft_count": self.ttft_count,
            "prefill_tokens": self.prefill_tokens_total,
            "decode_tokens": self.decode_tokens_total,
            "sub_steps": self.total_sub_steps,
            "graph_captures": self.graph_captures,
            "graph_replays": self.graph_replays,
            "graph_capture_s": self.graph_capture_s,
        }
        if self._radix is not None:
            hit, miss = self.prefix_hit_tokens_total, self.prefix_miss_tokens_total
            out["prefix_hits"] = self.prefix_hits
            out["prefix_misses"] = self.prefix_misses
            out["prefix_hit_tokens"] = hit
            out["prefix_miss_tokens"] = miss
            if hit + miss:
                out["prefix_hit_token_ratio"] = round(hit / (hit + miss), 4)
            out["prefix_cache_pages"] = self._radix.pages_held
            out["prefix_cache_nodes"] = self._radix.node_count
        if self.spec_verifies_total:
            out["spec_tokens_per_verify"] = round(
                self.spec_emitted_total / self.spec_verifies_total, 2)
            out["spec_verifies"] = self.spec_verifies_total
            out["spec_emitted"] = self.spec_emitted_total
        if self.ttft_samples:
            ttft = sorted(self.ttft_samples)
            out["ttft_p50_ms"] = round(ttft[len(ttft) // 2] * 1e3, 2)
            out["ttft_p95_ms"] = round(ttft[int(len(ttft) * 0.95)] * 1e3, 2)
        return out

    # -------------------------------------------------------- device calls

    def _stage(self, arr: np.ndarray) -> Tensor:
        """A host array as a tensor to copy to the device with
        ``non_blocking=True``: on the card in pinned memory from PyTorch's
        caching host allocator, which records the copy's event and hands
        the block out again only after it has fired, so no staging buffer
        is rewritten under a copy in flight; on the CPU a private copy."""
        t = torch.from_numpy(np.array(arr))
        return t.pin_memory() if self.device.type == "cuda" else t

    def _to_device(self, arr: np.ndarray) -> Tensor:
        return self._stage(arr).to(self.device, non_blocking=True)

    @contextlib.contextmanager
    def _called(self):
        """A public device call's context: on the card, the engine's stream
        waits for the caller's (the inputs), runs the call, and the
        caller's stream waits for it before the results come back; a call
        already on the engine's stream (a tick, a capture) runs as it is."""
        caller = torch.cuda.current_stream(self.device) if self.stream is not None else None
        if caller is None or caller == self.stream:
            yield None
            return
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield caller
        caller.wait_stream(self.stream)

    def prefill_forward(self, ids: np.ndarray, lens: np.ndarray, scat: np.ndarray,
                        prior_table: Optional[np.ndarray] = None,
                        n_prior: Optional[np.ndarray] = None) -> Tensor:
        """:meth:`_prefill_forward` on the engine's stream, its logits ready
        on the caller's."""
        with self._called() as caller:
            logits = self._prefill_forward(ids, lens, scat, prior_table, n_prior)
            if caller is not None:
                logits.record_stream(caller)
        return logits

    def decode_forward(self, tok: Tensor, lens: Tensor, page_table: Tensor,
                       write_mask: Optional[Tensor] = None) -> Tensor:
        """:meth:`_decode_forward` on the engine's stream, its logits ready
        on the caller's."""
        with self._called() as caller:
            logits = self._decode_forward(tok, lens, page_table, write_mask)
            if caller is not None:
                logits.record_stream(caller)
        return logits

    def _prefill_forward(self, ids: np.ndarray, lens: np.ndarray, scat: np.ndarray,
                         prior_table: Optional[np.ndarray] = None,
                         n_prior: Optional[np.ndarray] = None) -> Tensor:
        """Prefill rows ``ids`` [b, W] (true lengths ``lens``) with plain
        attention, scatter their KV into the pages ``scat`` [b, W/page], and
        return each row's last prompt logit [b, V].

        With ``prior_table`` [b, PNB] and ``n_prior`` [b], row r's first
        ``n_prior[r]`` tokens are already in the pool on those pages (a
        prefix-cache hit, or a chunked prompt's earlier segments): a dense
        cache is primed from them (dequantized from an int8 pool), the row's
        tokens run at positions from ``n_prior[r]``, and only its new window
        is scattered. Pad pages of a prior table point at scratch page 0;
        every key past a row's prior lies past its queries' positions."""
        dev, cfg = self.device, self.cfg
        b, width = ids.shape
        ids_t = self._to_device(ids)
        positions = torch.arange(width, device=dev)[None, :].expand(b, width)
        # only the last prompt token's logits are sampled from
        last = self._to_device(lens.astype(np.int64) - 1)
        if prior_table is None:
            cache = init_cache(cfg, b, width, dev)
            logits, cache = llama_forward(self.params, cfg, ids_t, positions=positions,
                                          cache=cache, cache_index=0, logit_index=last)
            k_new, v_new = cache["k"], cache["v"]
        else:
            prior_w = prior_table.shape[1] * self.page_size
            n_prior_t = self._to_device(n_prior.astype(np.int64))
            cache = init_cache(cfg, b, prior_w + width, dev)
            if prior_w:
                table = self._to_device(prior_table.astype(np.int64))
                for name, pages in (("k", self.pool.k), ("v", self.pool.v)):
                    cache[name][:, :, :prior_w] = _gather_prior(pages, table, cfg.torch_dtype)
            logits, cache = llama_forward(self.params, cfg, ids_t,
                                          positions=positions + n_prior_t[:, None],
                                          cache=cache, cache_index=n_prior_t,
                                          logit_index=last)
            # each row's new KV starts at its own offset in the primed cache
            window = n_prior_t[:, None] + torch.arange(width, device=dev)[None, :]
            rows = torch.arange(b, device=dev)[:, None]
            k_new, v_new = cache["k"][:, rows, window], cache["v"][:, rows, window]
        scatter_prefill(self.pool.k, self.pool.v, k_new, v_new,
                        self._to_device(scat.astype(np.int64)))
        return logits[:, 0]

    def _decode_forward(self, tok: Tensor, lens: Tensor, page_table: Tensor,
                        write_mask: Optional[Tensor] = None) -> Tensor:
        """One decode sub-step over the pool → logits [B, V]."""
        return paged_decode_forward(self.params, self.cfg, tok, lens, page_table,
                                    self.pool.k, self.pool.v, attn_impl=self.attn_impl,
                                    write_mask=write_mask, rope=self._rope)

    def _sub_step(self, all_greedy: bool, any_top_k: bool) -> None:
        """One decode sub-step of the slot batch on the static buffers: the
        forward, sampling and the state update, all in place. Rows that are
        halted or past their budget are frozen (their KV write goes to
        scratch page 0). This is what a CUDA graph captures; it reads
        nothing back to the host."""
        st = self._st
        active = (~st.halted) & (st.idx < st.budgets)
        logits = self._decode_forward(st.tok, st.lens, st.table, write_mask=active)
        nxt, lp = sample_tokens(logits, self._gen, st.temps, st.top_ks,
                                all_greedy=all_greedy, any_top_k=any_top_k)
        st.tok.copy_(torch.where(active, nxt, st.tok))
        st.lens.copy_(torch.where(active, st.lens + 1, st.lens))
        st.lp_sum.copy_(torch.where(active, st.lp_sum + lp, st.lp_sum))
        st.lp_min.copy_(torch.where(active, torch.minimum(st.lp_min, lp), st.lp_min))
        st.lp_cnt.copy_(torch.where(active, st.lp_cnt + 1, st.lp_cnt))
        if not self.ignore_eos:
            st.halted.copy_(st.halted | (active & (nxt == self.tokenizer.eos_id)))
        st.packed.index_copy_(0, st.idx + 1, nxt[None, :])
        st.idx.add_(1)

    def _capture(self, variant: tuple[bool, bool]) -> None:
        """Capture :meth:`_sub_step` for one sampling variant into a CUDA
        graph. The warmup before it runs on a side stream with every row
        masked (budgets 0), so it writes only scratch page 0 and moves no
        live state; it is a real sub-step and counts as one. The capture
        launches nothing, so the kernels' launch counts are put back and
        the graph's launches per kernel are kept, to be added at each
        replay. No other thread may launch work during a capture: the
        service captures every variant in its warmup, before traffic."""
        st = self._st
        st.budgets.zero_()
        st.idx.zero_()
        self._capture_graph(variant, lambda: self._sub_step(*variant),
                            sampled=not variant[0], after_warmup=st.idx.zero_)
        self.total_sub_steps += 1

    def _capture_graph(self, variant: tuple, body, sampled: bool, after_warmup=None) -> None:
        """Run ``body`` once on a side stream (its warmup), then capture it
        on the engine's stream into a CUDA graph in the engine's graph
        pool, kept as ``variant`` with its launches per kernel. ``sampled``
        bodies draw from the engine's own generator. The capture's mode is
        ``thread_local``: sibling engines' pumps keep launching, replaying
        and waiting on their own streams meanwhile, and only this thread's
        launches (:func:`launch_tally`) are charged to the graph."""
        with CAPTURE_LOCK:
            t0 = time.perf_counter()
            current = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(current)
            with torch.cuda.stream(side):
                body()
            current.wait_stream(side)
            if after_warmup is not None:
                after_warmup()
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            if sampled:
                graph.register_generator_state(self._gen)
            with launch_tally() as tally, torch.cuda.graph(
                    graph, pool=self._graph_pool, stream=self.stream,
                    capture_error_mode="thread_local"):
                body()
            # the capture launched nothing: take its launches back off the
            # counts and keep them to add at each replay
            launches = [(kernel, tally.get(kernel, 0)) for kernel in KERNELS]
            for kernel, captured in launches:
                kernel.add_launches(-captured)
            self._graphs[variant] = (graph, launches)
            self.graph_captures += 1
            self.graph_capture_s += time.perf_counter() - t0

    def _run_sub_steps(self, n_steps: int, variant: tuple[bool, bool]) -> None:
        if not (self.device.type == "cuda" and self.cuda_graphs):
            for _ in range(n_steps):
                self._sub_step(*variant)
            return
        self._replay(variant, n_steps)

    # -------------------------------------------------------------- private

    def _free_slot_indices(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if not s.active]

    def _prefill_width(self, n_tokens: int) -> int:
        width = bucket_size(
            max(n_tokens, self.page_size),
            tuple(b for b in self.PREFILL_BUCKETS if b % self.page_size == 0)
            or (self.page_size,),
        )
        return ((width + self.page_size - 1) // self.page_size) * self.page_size

    def _match_radix(self, tok_ids: Sequence[int]):
        """Longest-prefix match, clamped so at least one suffix token
        remains to prefill (the first token comes from the last prompt
        logit). → (shared, pages, node)."""
        if self._radix is None or self._radix.empty:
            return 0, [], None
        matched, pages, node = self._radix.match(tok_ids)
        max_shared = ((len(tok_ids) - 1) // self.page_size) * self.page_size
        if matched > max_shared:
            matched = max_shared
            pages = pages[: matched // self.page_size]
        if matched <= 0:
            return 0, [], None
        return matched, pages, node

    def _radix_insert(self, slot_idx: int, tok_ids, shared: int) -> None:
        """Move slot ``slot_idx``'s freshly prefilled full-page prompt span
        ``[shared, full)`` into the radix cache, after the dispatch that
        writes it (later admissions' reads are ordered behind the write on
        the stream). Donated pages change owner; the slot re-pins the
        deepest node so eviction cannot take pages its table references."""
        if self._radix is None:
            return
        slot = self.slots[slot_idx]
        full = (len(tok_ids) // self.page_size) * self.page_size
        if full <= shared:
            return
        own = slot.pages[: (full - shared) // self.page_size]
        node, donated = self._radix.insert(list(tok_ids[:full]), shared, own)
        slot.donated.extend(donated)
        if node is not None and node is not slot.prefix_node:
            self._radix.lock(node)
            self._radix.unlock(slot.prefix_node)
            slot.prefix_node = node

    def _admit(self) -> None:
        """Admit queued requests into free slots (radix match, pages,
        skip-ahead), then prefill them grouped by suffix width, hits apart
        from cold rows, in chunks of up to max(ADMIT_BUCKETS) rows."""
        free = self._free_slot_indices()
        if not free or not self._queue:
            return
        window = self.max_pages_per_seq * self.page_size
        # a verify block writes KV up to spec_k + 1 positions past the
        # accepted length before acceptance is known: pages must back them
        spec_head = self._spec_head
        batch: list[tuple[int, _Request, list[int], int]] = []
        now = time.perf_counter()
        qi = 0
        while qi < len(self._queue) and free:
            req = self._queue[qi]
            if req.deadline_ts is not None and now >= req.deadline_ts:
                # the caller's deadline passed while queued: drop it before
                # paying for its prefill
                self._queue.pop(qi)
                if qi == 0:
                    self._head_skips = 0
                self._finished.append(PagedResult(
                    request_id=req.request_id, text="", tokens=[], prompt_tokens=0,
                    finish_reason="expired"))
                continue
            if req.tok_ids is None:
                # generation gets its tokens up to HALF the window; the
                # prompt always keeps at least the other half (prior tokens
                # count as generation, so the prompt truncates as without)
                prior = req.prior_tokens or []
                reserve = min(req.max_new + len(prior) + 2, window // 2)
                req.tok_ids = (self.tokenizer.encode(req.prompt, add_bos=True)[: window - reserve]
                               + list(prior))
                if req.seed is not None:
                    fold_seed(self._gen, req.seed)
            tok_ids = req.tok_ids
            cache_live = self._radix is not None and not self._radix.empty
            shared, match_pages, match_node = self._match_radix(tok_ids)

            def pages_needed(sh: int) -> int:
                return min((len(tok_ids) - sh + req.max_new + spec_head + self.page_size - 1)
                           // self.page_size, self.max_pages_per_seq - sh // self.page_size)

            need = pages_needed(shared)
            if need > self.allocator.free_pages and self._radix is not None:
                # reclaim unpinned cached prefixes, LRU first; the match may
                # have walked nodes that were just freed, so match again
                if self._radix.evict(need - self.allocator.free_pages):
                    shared, match_pages, match_node = self._match_radix(tok_ids)
                    need = pages_needed(shared)
            if need > self.allocator.free_pages:
                if qi == 0 and self._head_skips >= self.head_skip_bound:
                    break
                qi += 1
                continue
            pages = self.allocator.alloc(need)
            slot_idx = free.pop(0)
            self._queue.pop(qi)
            if qi == 0:
                self._head_skips = 0
            else:
                self._head_skips += 1
            if cache_live:
                if shared:
                    self.prefix_hits += 1
                else:
                    self.prefix_misses += 1
            if self._radix is not None:
                self.prefix_hit_tokens_total += shared
                self.prefix_miss_tokens_total += len(tok_ids) - shared
                self._radix.lock(match_node)
            chunked = (self.prefill_chunk is not None
                       and len(tok_ids) - shared > self.prefill_chunk)
            if not chunked:
                batch.append((slot_idx, req, tok_ids, shared))
            slot = self.slots[slot_idx]
            slot.request_id = req.request_id
            slot.pages = pages
            slot.prompt_tokens = slot.length = len(tok_ids)
            slot.max_new = req.max_new
            slot.temperature = req.temperature
            slot.top_k = req.top_k
            slot.emitted = []
            slot.inflight_steps = 0
            slot.shared_tokens = shared
            slot.prefix_node = match_node
            slot.prompt_ids = list(tok_ids) if self._radix is not None else None
            slot.donated = []
            slot.submit_t = req.submit_t
            slot.prefill_todo = list(tok_ids[shared:]) if chunked else None
            slot.prefill_done = 0
            slot.active = True
            shared_blocks = shared // self.page_size
            self._page_table[slot_idx] = 0
            self._page_table[slot_idx, :shared_blocks] = match_pages
            self._page_table[slot_idx, shared_blocks : shared_blocks + len(pages)] = pages
            self._temps[slot_idx] = req.temperature
            self._top_ks[slot_idx] = req.top_k

        # rows group by suffix width, rows with a prefix hit apart from cold
        # ones (which take the plain prefill); nothing is compiled per shape,
        # so a chunk's prior table is as wide as its largest prior
        groups: dict[tuple[int, bool], list] = {}
        for item in batch:
            shared = item[3]
            groups.setdefault((self._prefill_width(len(item[2]) - shared), shared > 0),
                              []).append(item)
        max_rows = max(self.ADMIT_BUCKETS)
        for (width, _hit), members in sorted(groups.items()):
            for start in range(0, len(members), max_rows):
                chunk = members[start : start + max_rows]
                pnb = max(shared for _i, _r, _t, shared in chunk) // self.page_size
                self._prefill_admitted(width, pnb, chunk)
        if self.draft_params is not None and batch:
            self._draft_prefill_admitted(batch)

    @property
    def _spec_head(self) -> int:
        """Positions past a row's length a spec tick may write."""
        return self.spec_k + 1 if self.draft_params is not None else 0

    def _ensure_spec(self):
        """The spec tick's buffers, made on first use."""
        if self._spec is None:
            from sentio_tpu_torch.runtime.paged_spec import SpecTick

            self._spec = SpecTick(
                self.cfg, self.params, self.draft_cfg, self.draft_params, self.spec_k,
                self.max_slots, self.max_pages_per_seq * self.page_size,
                self.max_tick_steps + self.spec_k + 1, self.tokenizer.eos_id,
                self.ignore_eos, self.device)
        return self._spec

    def _draft_prefill_admitted(self, batch: list) -> None:
        """Fill the draft cache rows of freshly admitted slots, always over
        the FULL prompt (prefix pages are target-only), grouped by prefill
        width like the target's admission; the width is clamped to the
        draft cache's window (prompts are truncated below it, so the clamp
        loses nothing). Like :meth:`_prefill_rows`, no dispatch's scores
        pass PREFILL_SCORE_BYTES."""
        spec = self._ensure_spec()
        window = self.max_pages_per_seq * self.page_size
        groups: dict[int, list] = {}
        for slot_idx, _req, tok_ids, _shared in batch:
            width = min(self._prefill_width(len(tok_ids)), window)
            groups.setdefault(width, []).append((slot_idx, tok_ids))
        for width, members in sorted(groups.items()):
            score_bytes = self.draft_cfg.n_heads * width * width * 4
            rows_per = max(1, min(max(self.ADMIT_BUCKETS),
                                  self.PREFILL_SCORE_BYTES // score_bytes))
            for start in range(0, len(members), rows_per):
                chunk = members[start : start + rows_per]
                n = len(chunk)
                rows = min(bucket_size(n, self.ADMIT_BUCKETS), rows_per)
                ids = np.full((rows, width), self.tokenizer.pad_id, np.int64)
                for r, (_slot, tok_ids) in enumerate(chunk):
                    ids[r, : len(tok_ids)] = tok_ids
                slots = np.asarray([slot_idx for slot_idx, _t in chunk], np.int64)
                with self._phase.phase("prefill_dispatch"):
                    spec.draft_prefill(self._to_device(ids), self._to_device(slots), n)

    def _prefill_admitted(self, width: int, pnb: int, chunk: list) -> None:
        """One admission group's prefill: suffix-only over the matched pages
        when ``pnb``, whole prompts otherwise. The first tokens stay on the
        device; each row's full-page span then enters the radix cache."""
        faults.hit("paged.admit_scatter")
        rows_data, n_prior, prior_rows = [], [], []
        for slot_idx, req, tok_ids, shared in chunk:
            rows_data.append((tok_ids[shared:], req.temperature, req.top_k,
                              self.slots[slot_idx].pages))
            n_prior.append(shared)
            prior_rows.append(self._page_table[slot_idx, : shared // self.page_size])
        first, first_lp = self._prefill_rows(width, pnb, rows_data, n_prior,
                                             prior_rows if pnb else None, do_sample=True)
        self.prefill_tokens_total += sum(len(t) - s for _i, _r, t, s in chunk)
        slot_idxs = [slot_idx for slot_idx, _r, _t, _s in chunk]
        for slot_idx in slot_idxs:
            self.slots[slot_idx].pending_first = True
        self._pending_first.append((first, first_lp, slot_idxs,
                                    [self.slots[i].request_id for i in slot_idxs]))
        for slot_idx, _req, tok_ids, shared in chunk:
            self._radix_insert(slot_idx, tok_ids, shared)

    def _prefill_rows(self, width: int, pnb: int, rows_data: list, n_prior: list,
                      prior_rows: Optional[list], do_sample: bool
                      ) -> tuple[Optional[Tensor], Optional[Tensor]]:
        """Prefill dispatch(es) for rows of one width over ``pnb`` prior
        pages: rows_data [(token ids, temperature, top_k, own pages)], each row's
        prior length and (with ``prior_rows``) prior page ids. Rows pad to a
        batch bucket (pad rows scatter to scratch page 0) and split so that
        no dispatch's scores exceed PREFILL_SCORE_BYTES. Returns the first
        tokens and their logprobs on the device, one per row, when
        ``do_sample``."""
        prior_w = pnb * self.page_size
        score_bytes = self.cfg.n_heads * width * (prior_w + width) * 4
        rows_per = max(1, self.PREFILL_SCORE_BYTES // score_bytes)
        if len(rows_data) > rows_per:
            parts = [self._prefill_rows(
                width, pnb, rows_data[s : s + rows_per], n_prior[s : s + rows_per],
                prior_rows[s : s + rows_per] if prior_rows is not None else None, do_sample)
                for s in range(0, len(rows_data), rows_per)]
            if not do_sample:
                return None, None
            return (torch.cat([f for f, _lp in parts]), torch.cat([lp for _f, lp in parts]))
        n = len(rows_data)
        rows = min(bucket_size(n, self.ADMIT_BUCKETS), max(rows_per, n))
        ids = np.full((rows, width), self.tokenizer.pad_id, np.int64)
        lens = np.ones(rows, np.int64)
        temps = np.zeros(rows, np.float32)
        top_ks = np.zeros(rows, np.int64)
        scat = np.zeros((rows, width // self.page_size), np.int64)
        for r, (tok_ids, temp, top_k, pages) in enumerate(rows_data):
            ids[r, : len(tok_ids)] = tok_ids
            lens[r] = len(tok_ids)
            temps[r] = temp
            top_ks[r] = top_k
            used = (len(tok_ids) + self.page_size - 1) // self.page_size
            scat[r, :used] = pages[:used]
        prior_table = n_prior_arr = None
        if prior_rows is not None:
            prior_table = np.zeros((rows, pnb), np.int64)
            for r, prior in enumerate(prior_rows):
                prior_table[r, : len(prior)] = prior
            n_prior_arr = np.zeros(rows, np.int64)
            n_prior_arr[:n] = n_prior
        with self._phase.phase("prefill_dispatch"):
            last = self._prefill_forward(ids, lens, scat, prior_table, n_prior_arr)
            if not do_sample:
                return None, None
            first, first_lp = sample_tokens(
                last, self._gen, self._to_device(temps), self._to_device(top_ks),
                all_greedy=bool((temps <= 0).all()), any_top_k=bool((top_ks > 0).any()))
        return first[:n], first_lp[:n]

    def _advance_prefill(self) -> None:
        """Dispatch ONE chunked-prefill segment per tick, for the slot with
        the oldest submit time (index order would let long prompts landing
        in lower slots starve a higher one)."""
        waiting = [(slot.submit_t, i) for i, slot in enumerate(self.slots)
                   if slot.active and slot.prefill_todo is not None]
        if not waiting:
            return
        i = min(waiting)[1]
        faults.hit("paged.admit_scatter")
        slot = self.slots[i]
        seg = slot.prefill_todo[: self.prefill_chunk]
        is_last = len(slot.prefill_todo) <= self.prefill_chunk
        prior = slot.shared_tokens + slot.prefill_done
        # the segment's own pages follow the prior blocks in the table
        # (prior is page-aligned: shared and every non-final segment are)
        pb = prior // self.page_size
        nb = (len(seg) + self.page_size - 1) // self.page_size
        first, first_lp = self._prefill_rows(
            self._prefill_width(len(seg)), pb,
            [(seg, slot.temperature, slot.top_k, self._page_table[i, pb : pb + nb].tolist())],
            [prior], [self._page_table[i, :pb]], do_sample=is_last)
        self.prefill_tokens_total += len(seg)
        if is_last:
            slot.prefill_todo = None
            slot.pending_first = True
            self._pending_first.append((first, first_lp, [i], [slot.request_id]))
            # the last segment completes the prompt's KV
            self._radix_insert(i, slot.prompt_ids, slot.shared_tokens)
        else:
            slot.prefill_todo = slot.prefill_todo[self.prefill_chunk :]
            slot.prefill_done += len(seg)

    def _dispatch_tick(self) -> Optional[dict]:
        """Per-row budgets, the admitted rows merged into the device decode
        state, ``budgets.max()`` sub-steps, and the asynchronous fetch of
        the tick's tokens. Nothing here waits for the device; the returned
        record is harvested later (at once at depth 1, one step later at
        depth 2)."""
        pending, self._pending_first = self._pending_first, []
        remaining = np.zeros(self.max_slots, np.int32)
        for i, slot in enumerate(self.slots):
            if not slot.active or slot.prefill_todo is not None:
                continue  # mid-chunked-prefill: no decode budget, no retire
            capacity = slot.shared_tokens + len(slot.pages) * self.page_size
            # a pending first token and sub-steps granted to an unharvested
            # tick count as if they had been folded
            base_emit = len(slot.emitted) + slot.inflight_steps + int(slot.pending_first)
            written = slot.length + slot.inflight_steps
            # a spec tick reserves its verify headroom inside the capacity; a
            # request at max_pages_per_seq pays it from its budget
            remaining[i] = max(min(slot.max_new - base_emit,
                                   capacity - 1 - self._spec_head - written), 0)
            if remaining[i] == 0 and not slot.pending_first and slot.inflight_steps == 0:
                self._finished.append(self._retire(i, "length"))
        # an idle queue runs the big tick; waiting requests (the engine's
        # queue and, through pressure_hint, the service's inbox) shrink it
        # so freed slots refill sooner
        waiting = len(self._queue)
        if self.pressure_hint is not None:
            waiting += int(self.pressure_hint())
        if waiting == 0:
            steps = self.max_tick_steps
        else:
            shrink = 1 << min(waiting // max(self.max_slots, 1), 2)
            steps = max(self.steps_per_tick // shrink, 2)
        if self.force_tick_steps in self.tick_step_sizes():
            steps = self.force_tick_steps
        budgets = np.minimum(remaining, steps).astype(np.int32)
        # a lane cancelled after its admission keeps no pending first token
        pending = [(first, first_lp, idxs, [self._live(i, rid) for i, rid in zip(idxs, rids)])
                   for first, first_lp, idxs, rids in pending]
        pending_slots = {i for _f, _lp, idxs, live in pending
                         for i, ok in zip(idxs, live) if ok}
        self.last_tick_active = int(((budgets > 0)
                                     | np.isin(np.arange(self.max_slots),
                                               list(pending_slots))).sum())
        if not budgets.any():
            if pending_slots:
                with self._phase.phase("device_wait"):
                    self._fold_pending(pending)
            return None

        st = self._st
        # the sampling variant: all rows greedy, or sampled with / without
        # some top-k row
        all_greedy = bool((self._temps <= 0).all())
        if self.draft_params is not None:
            return self._dispatch_spec_tick(pending, pending_slots, budgets, all_greedy)
        variant = (all_greedy, not all_greedy and bool((self._top_ks > 0).any()))
        if self.device.type == "cuda" and self.cuda_graphs and variant not in self._graphs:
            if self.graphs_frozen:
                raise RuntimeError(f"decode tick needs a CUDA graph for sampling variant "
                                   f"{variant}, which warmup did not capture")
            self._capture(variant)
        st.table.copy_(self._stage(self._page_table), non_blocking=True)
        st.budgets.copy_(self._stage(budgets), non_blocking=True)
        st.temps.copy_(self._stage(self._temps), non_blocking=True)
        st.top_ks.copy_(self._stage(self._top_ks), non_blocking=True)
        self._merge_admitted(pending)
        if not self.ignore_eos:
            # rows whose deferred first token is already EOS never run
            st.halted.copy_(st.halted | (st.tok == self.tokenizer.eos_id))
        st.packed[0].copy_(st.tok)
        st.idx.zero_()
        n_steps = int(budgets.max())
        self._run_sub_steps(n_steps, variant)
        self.total_sub_steps += n_steps
        # the tick's one fetch: tokens [1 + n_steps, B] and logprob state
        # [3, B] into pinned blocks of the caching host allocator, behind an
        # event; the record holds them until its harvest
        pin = self.device.type == "cuda"
        host_packed = torch.empty((1 + n_steps, self.max_slots), dtype=torch.int64,
                                  pin_memory=pin)
        host_lp = torch.empty((3, self.max_slots), dtype=torch.float32, pin_memory=pin)
        host_packed.copy_(st.packed[: 1 + n_steps], non_blocking=True)
        host_lp.copy_(torch.stack([st.lp_sum, st.lp_min, st.lp_cnt.float()]),
                      non_blocking=True)
        event = None
        if self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        for i, slot in enumerate(self.slots):
            if slot.active:
                slot.inflight_steps += int(budgets[i])
        return {"packed": host_packed, "lp_state": host_lp, "event": event,
                "budgets": budgets, "pending_slots": pending_slots,
                # a lane retired and re-admitted before this record is
                # harvested must not get the old request's tokens
                "rids": [s.request_id for s in self.slots]}

    def _dispatch_spec_tick(self, pending: list, pending_slots: set, budgets: np.ndarray,
                            all_greedy: bool) -> dict:
        """A spec tick (:class:`~.paged_spec.SpecTick`): the admitted rows
        merged into the decode state, the pool densified, rounds until every
        row is done (a graph replay each on the card; the host reads the
        rows' done flags after each), the dense cache scattered back, and
        the asynchronous fetch of the packed block. The logprob accumulators
        pass through unchanged: spec results report ``logprob_count == 0``."""
        st, spec = self._st, self._ensure_spec()
        st.table.copy_(self._stage(self._page_table), non_blocking=True)
        st.budgets.copy_(self._stage(budgets), non_blocking=True)
        st.temps.copy_(self._stage(self._temps), non_blocking=True)
        self._merge_admitted(pending)
        spec.begin(st, self.pool)
        variant = ("spec", all_greedy)
        graphs = self.device.type == "cuda" and self.cuda_graphs
        if graphs and variant not in self._graphs:
            if self.graphs_frozen:
                raise RuntimeError(f"spec tick needs a CUDA graph for variant {variant}, "
                                   f"which warmup did not capture")
            self._capture_spec(variant)
        # every live row emits at least one token a round
        limit = int(budgets.max())
        rounds = 0
        while True:
            if graphs:
                self._replay(variant)
            else:
                spec.round(st, all_greedy, self._gen)
            rounds += 1
            with self._phase.phase("device_wait"):
                if self._all_done(spec.done):
                    break
            if rounds >= limit:
                raise RuntimeError(f"spec tick: rows still live after {rounds} rounds")
        self.spec_rounds_total += rounds
        spec.end(st, self.pool)
        packed = spec.packed()
        pin = self.device.type == "cuda"
        host_packed = torch.empty(packed.shape, dtype=torch.int64, pin_memory=pin)
        host_packed.copy_(packed, non_blocking=True)
        event = None
        if pin:
            event = torch.cuda.Event()
            event.record()
        for i, slot in enumerate(self.slots):
            if slot.active:
                slot.inflight_steps += int(budgets[i])
        return {"packed": host_packed, "lp_state": None, "event": event, "spec": True,
                "budgets": budgets, "pending_slots": pending_slots,
                "rids": [s.request_id for s in self.slots]}

    def _all_done(self, done: Tensor) -> bool:
        """Every row of the spec tick is done; on the card through a
        pinned copy and an event, which waits for the round."""
        if self.device.type != "cuda":
            return bool(done.all())
        if self._done_host is None:
            self._done_host = torch.empty(done.shape, dtype=torch.bool, pin_memory=True)
        self._done_host.copy_(done, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        event.synchronize()
        return bool(self._done_host.all())

    def _capture_spec(self, variant: tuple) -> None:
        """Capture one spec round (:meth:`SpecTick.round`) into a CUDA
        graph, as :meth:`_capture` captures a sub-step. The warmup before it
        runs with every row marked done, so it moves no state (its cache
        writes land past each row's length, which the next round writes
        before any query reads); the rows' done flags are then put back.
        The sampled variant draws from the engine's generator."""
        st, spec = self._st, self._spec
        all_greedy = variant[1]
        live_done = spec.done.clone()
        spec.done.fill_(True)
        self._capture_graph(variant, lambda: spec.round(st, all_greedy, self._gen),
                            sampled=not all_greedy)
        spec.done.copy_(live_done)

    def _replay(self, variant: tuple, n: int = 1) -> None:
        """Replay a captured graph ``n`` times, adding its launches."""
        graph, launches = self._graphs[variant]
        for _ in range(n):
            graph.replay()
        for kernel, count in launches:
            kernel.add_launches(count * n)
        self.graph_replays += n

    def _live(self, i: int, request_id: int) -> bool:
        """Slot ``i`` still serves ``request_id``."""
        return self.slots[i].active and self.slots[i].request_id == request_id

    def _merge_admitted(self, pending: list) -> None:
        """Scatter the admitted rows' device-resident first tokens, prompt
        lengths, a cleared halt flag and the first logprob seeding the
        accumulators into the decode state; zero the lens of lanes retired
        since the last tick."""
        st = self._st
        keep = [ok for _f, _lp, _s, live in pending for ok in live]
        idxs = [i for _f, _lp, slot_idxs, live in pending
                for i, ok in zip(slot_idxs, live) if ok]
        stale = sorted(self._stale_lanes - set(idxs))
        self._stale_lanes.clear()
        if stale:
            st.lens.index_fill_(0, self._to_device(np.asarray(stale, np.int64)), 0)
        if not idxs:
            return
        idx = self._to_device(np.asarray(idxs, np.int64))
        first = torch.cat([f for f, _lp, _s, _l in pending])
        first_lp = torch.cat([lp for _f, lp, _s, _l in pending])
        if not all(keep):
            picked = self._to_device(np.flatnonzero(keep))
            first, first_lp = first[picked], first_lp[picked]
        st.tok.index_copy_(0, idx, first)
        st.lens.index_copy_(0, idx, self._to_device(
            np.asarray([self.slots[i].length for i in idxs], np.int32)))
        st.halted.index_fill_(0, idx, False)
        st.lp_sum.index_copy_(0, idx, first_lp)
        st.lp_min.index_copy_(0, idx, first_lp)
        st.lp_cnt.index_fill_(0, idx, 1)

    def _fold_pending(self, pending: list) -> None:
        """Nothing can decode, but deferred first tokens need folding (a
        max_new_tokens=1 burst): fetch them directly instead of running a
        fully masked tick. The fetch waits for the device."""
        for first, first_lp, slot_idxs, live in pending:
            vals, lps = first.cpu().numpy(), first_lp.cpu().numpy()
            for r, i in enumerate(slot_idxs):
                slot = self.slots[i]
                if not live[r]:
                    continue
                slot.pending_first = False
                self._note_ttft(slot)
                self._last_tok[i] = int(vals[r])
                self._lp_sum[i] = self._lp_min[i] = lps[r]
                self._lp_cnt[i] = 1
                result = self._fold_and_maybe_retire(i)
                if result is not None:
                    self._finished.append(result)

    def _harvest(self, record: dict) -> list[PagedResult]:
        """Wait for a tick's fetch (its event, nothing else) and replay the
        device's halting rule on the host: a row runs until its budget or
        the sub-step after its first EOS; each executed sub-step folds one
        token and checks retirement."""
        if record["event"] is not None:
            record["event"].synchronize()
        budgets = record["budgets"]
        packed = record["packed"].numpy()
        spec = record.get("spec", False)
        lp_rows = None if spec else record["lp_state"].numpy()
        finished: list[PagedResult] = []
        for i, slot in enumerate(self.slots):
            if not slot.active or slot.request_id != record["rids"][i]:
                continue  # lane retired (and maybe reused) since dispatch
            consumed = int(budgets[i])
            if not consumed and i not in record["pending_slots"]:
                continue
            slot.inflight_steps = max(slot.inflight_steps - consumed, 0)
            if lp_rows is not None:
                self._lp_sum[i], self._lp_min[i] = lp_rows[0, i], lp_rows[1, i]
                self._lp_cnt[i] = int(lp_rows[2, i])
            if slot.pending_first and i in record["pending_slots"]:
                slot.pending_first = False
                self._note_ttft(slot)
                self._last_tok[i] = int(packed[i, 0] if spec else packed[0, i])
                result = self._fold_and_maybe_retire(i)
                if result is not None:
                    finished.append(result)
                    continue
            if spec:
                # a spec row: [echo, emitted, verifies, tokens...], budgets
                # and EOS already applied on the device; total_sub_steps
                # counts emitted tokens (the spec analogue of sub-steps)
                n = int(packed[i, 1])
                toks = packed[i, 3 : 3 + n]
                self.total_sub_steps += n
                self.spec_emitted_total += n
                self.spec_verifies_total += int(packed[i, 2])
            else:
                n = consumed
                toks = packed[1 : 1 + n, i]
            for s in range(n):
                slot.length += 1
                self._last_tok[i] = int(toks[s])
                result = self._fold_and_maybe_retire(i)
                if result is not None:
                    finished.append(result)
                    break
        return finished

    def _fold_and_maybe_retire(self, i: int) -> Optional[PagedResult]:
        """Fold ``_last_tok[i]`` into slot ``i``; retire on EOS / token
        budget / page capacity — the one place these conditions live."""
        slot = self.slots[i]
        tok = int(self._last_tok[i])
        self.decode_tokens_total += 1
        hit_eos = tok == self.tokenizer.eos_id and not self.ignore_eos
        if not hit_eos:
            slot.emitted.append(tok)
        hit_len = len(slot.emitted) >= slot.max_new
        capacity = slot.shared_tokens + len(slot.pages) * self.page_size
        out_of_pages = slot.length + 1 >= capacity
        if hit_eos or hit_len or out_of_pages:
            return self._retire(i, "stop" if hit_eos else "length")
        return None

    def _note_ttft(self, slot: _Slot) -> None:
        """Called where ``pending_first`` flips False: the moment the first
        sampled token is visible on the host."""
        if slot.submit_t > 0.0:
            self.ttft_samples.append(time.perf_counter() - slot.submit_t)
            self.ttft_count += 1

    def _retire(self, i: int, reason: str) -> PagedResult:
        """Free a slot's pages (minus those donated to the radix cache),
        drop its prefix pin and zero its host mirror row."""
        slot = self.slots[i]
        result = PagedResult(
            request_id=slot.request_id,
            text=self.tokenizer.decode(slot.emitted),
            tokens=list(slot.emitted),
            prompt_tokens=slot.prompt_tokens,
            finish_reason=reason,
            prefill_tokens=slot.prompt_tokens - slot.shared_tokens,
            prefix_hit_tokens=slot.shared_tokens,
            logprob_sum=float(self._lp_sum[i]),
            logprob_min=float(self._lp_min[i]),
            logprob_count=int(self._lp_cnt[i]),
        )
        donated = set(slot.donated)
        self.allocator.free([p for p in slot.pages if p not in donated])
        if self._radix is not None:
            self._radix.unlock(slot.prefix_node)
        self.slots[i] = _Slot()
        self._stale_lanes.add(i)
        self._page_table[i] = 0
        self._temps[i] = 0.0
        self._top_ks[i] = 0
        self._last_tok[i] = 0
        self._lp_sum[i] = self._lp_min[i] = 0.0
        self._lp_cnt[i] = 0
        return result
