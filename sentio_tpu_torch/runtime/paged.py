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

One engine tick:

* **admission** — queued requests prefill as width-bucketed batches (one
  contiguous prefill forward, a scatter of the cache into each row's pages,
  the first token sampled from each row's last prompt logit);
* **one fused multi-step decode** — a Python loop of sub-steps over the
  slot batch with per-row budgets (token budget and page capacity), EOS
  halting and running logprob accumulators; the tokens come back to the
  host in one fetch at the end of the tick, and the host replays the
  halting rule to fold them;
* **retirement** on EOS / length, freeing pages.

The pool is updated in place (the JAX engine donates its buffers to the
same effect). Decode attention goes through the paged kernel of the pool's
representation (:func:`sentio_tpu_torch.kernels.paged_attn_impl`), or
through the plain gather path when ``attn_impl`` is set to
``_paged_attn_xla``. Prefill keeps plain attention over the dense,
unquantized cache, as the JAX engine does: an int8 pool quantizes what is
written into its pages, so the first token is sampled from an unquantized
prefill. Left for later slices: the radix prefix cache, chunked prefill,
speculation, ``pipeline_depth=2`` and meshes — none of them changes greedy
output.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from sentio_tpu_torch import resolve_device
from sentio_tpu_torch.kernels import paged_attn_impl
from sentio_tpu_torch.kernels.paged_attention import (
    QuantPages,
    paged_attention_plain,
    paged_attention_quant_plain,
)
from sentio_tpu_torch.models import layers as L
from sentio_tpu_torch.models.llama import LlamaConfig, init_cache, init_llama, llama_forward
from sentio_tpu_torch.models.tokenizer import ByteTokenizer
from sentio_tpu_torch.parallel.batcher import bucket_size
from sentio_tpu_torch.runtime.sampling import sample_tokens

Tensor = torch.Tensor
Pages = Union[Tensor, QuantPages]  # a pool's k or v, or one layer of it


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
                         attn_impl=None, write_mask: Optional[Tensor] = None) -> Tensor:
    """One decode step over the paged pool → logits [B, V] float32.

    tok [B] (last sampled token per slot); lens [B] int32, the absolute
    position the new token occupies; page_table [B, NB] int32. This step's
    k/v are written into each row's current page in place before attention
    reads them (quantized first for an int8 pool). ``write_mask`` [B] bool
    redirects masked rows' writes to the
    scratch page, freezing rows that hit EOS or their budget mid-tick."""
    dt = cfg.torch_dtype
    b = tok.shape[0]
    h, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    page = _page_dim(k_pages)
    nb = page_table.shape[1]
    positions = lens.long()[:, None]  # [B, 1]
    cos, sin = L.rope_frequencies(hd, max(nb * page, cfg.max_len), cfg.rope_theta,
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
    pages: list[int] = field(default_factory=list)
    length: int = 0          # tokens currently in cache (prompt + generated)
    prompt_tokens: int = 0
    max_new: int = 0
    emitted: list[int] = field(default_factory=list)
    active: bool = False


@dataclass
class _Request:
    request_id: int
    prompt: str
    max_new: int
    temperature: float


@dataclass
class PagedResult:
    request_id: int
    text: str
    tokens: list[int]
    prompt_tokens: int
    finish_reason: str  # "stop" | "length"
    # sampled-token logprob accumulators (sum / min / count over every token
    # this request sampled, EOS included)
    logprob_sum: float = 0.0
    logprob_min: float = 0.0
    logprob_count: int = 0

    @property
    def logprob_mean(self) -> Optional[float]:
        if self.logprob_count <= 0:
            return None
        return self.logprob_sum / self.logprob_count

    def stats_dict(self) -> dict:
        return {
            "logprob_sum": self.logprob_sum,
            "logprob_min": self.logprob_min,
            "logprob_count": self.logprob_count,
            "logprob_mean": self.logprob_mean,
            "tokens": len(self.tokens),
            "finish_reason": self.finish_reason,
        }


class ContinuousBatchingEngine:
    """Slot-based continuous batching over the paged pool.

    ``max_slots`` decode lanes run one fused multi-step tick per ``step()``;
    requests are admitted into free lanes in arrival order and retired on
    EOS / length. The pool holds ``max_pages_per_seq`` pages for every slot
    (plus scratch), so a free slot always finds its pages. ``attn_impl`` is
    the decode-attention seam: the paged kernel by default, the plain
    gather path (``_paged_attn_xla``) when set to it. ``kv_quant="int8"``
    stores the pool as int8 codes plus f16 scales (``KV_QUANT``), which
    routes decode to the int8 kernel. Single-threaded: one caller drives
    ``step()``."""

    PREFILL_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)
    ADMIT_BUCKETS = (1, 2, 4, 8)
    # transient f32 score bytes one prefill dispatch may materialize
    # ([rows, H, W, W] in plain attention); wider batches prefill in parts
    PREFILL_SCORE_BYTES = 2 << 30

    def __init__(
        self,
        model_config: Optional[LlamaConfig] = None,
        params: Optional[dict] = None,
        max_slots: int = 8,
        page_size: int = 16,
        max_pages_per_seq: int = 16,
        rng_seed: int = 0,
        steps_per_tick: int = 8,
        max_tick_steps: Optional[int] = None,
        kv_quant: str = "none",
        device=None,
    ) -> None:
        if kv_quant not in ("none", "int8"):
            raise ValueError(f"kv_quant must be 'none' or 'int8', got {kv_quant!r}")
        self.device = resolve_device(device)
        self.cfg = model_config or LlamaConfig.tiny()
        self.tokenizer = ByteTokenizer(self.cfg.vocab_size)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(rng_seed + 1)
        if params is None:
            init_gen = torch.Generator(device=self.device)
            init_gen.manual_seed(rng_seed)
            params = init_llama(self.cfg, init_gen, self.device)
        self.params = params
        self.max_slots = max_slots
        self.page_size = page_size
        self.max_pages_per_seq = max_pages_per_seq
        self.steps_per_tick = max(int(steps_per_tick), 1)
        self.max_tick_steps = (max(int(max_tick_steps), self.steps_per_tick)
                               if max_tick_steps is not None else self.steps_per_tick)
        num_pages = 1 + max_slots * max_pages_per_seq
        self.kv_quant = kv_quant
        self.pool = init_pool(self.cfg, num_pages, page_size, self.device,
                              quantized=kv_quant == "int8")
        self.allocator = PageAllocator(num_pages)
        self.attn_impl = paged_attn_impl

        self.slots = [_Slot() for _ in range(max_slots)]
        self._queue: list[_Request] = []
        self._finished: list[PagedResult] = []
        self._next_id = itertools.count()
        self.total_sub_steps = 0
        # host mirrors of per-slot decode state
        self._page_table = np.zeros((max_slots, max_pages_per_seq), np.int32)
        self._lens = np.zeros(max_slots, np.int32)
        self._temps = np.zeros(max_slots, np.float32)
        self._last_tok = np.zeros(max_slots, np.int64)
        self._lp_sum = np.zeros(max_slots, np.float32)
        self._lp_min = np.zeros(max_slots, np.float32)
        self._lp_cnt = np.zeros(max_slots, np.int32)

    # --------------------------------------------------------------- public

    def submit(self, prompt: str, max_new_tokens: int = 64, temperature: float = 0.0) -> int:
        rid = next(self._next_id)
        self._queue.append(_Request(rid, prompt, max_new_tokens, temperature))
        return rid

    @property
    def has_work(self) -> bool:
        return bool(self._queue) or any(s.active for s in self.slots)

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
        """One tick: admit waiting requests, run one fused multi-step decode
        over the active slots, retire finished ones. Returns the results
        completed this tick."""
        self._admit()
        if any(s.active for s in self.slots):
            self._tick()
        out, self._finished = self._finished, []
        return out

    # -------------------------------------------------------- device calls

    def prefill_forward(self, ids: np.ndarray, lens: np.ndarray,
                        scat: np.ndarray) -> Tensor:
        """Prefill rows ``ids`` [b, W] (true lengths ``lens``) with plain
        attention, scatter their KV into the pages ``scat`` [b, W/page],
        and return each row's last prompt logit [b, V]."""
        b, width = ids.shape
        ids_t = torch.as_tensor(ids, device=self.device)
        positions = torch.arange(width, device=self.device)[None, :].expand(b, width)
        cache = init_cache(self.cfg, b, width, self.device)
        logits, cache = llama_forward(self.params, self.cfg, ids_t,
                                      positions=positions, cache=cache, cache_index=0)
        scatter_prefill(self.pool.k, self.pool.v, cache["k"], cache["v"],
                        torch.as_tensor(scat, device=self.device))
        last = torch.as_tensor(lens - 1, device=self.device).long()
        return logits[torch.arange(b, device=self.device), last]

    def decode_forward(self, tok: Tensor, lens: Tensor, page_table: Tensor,
                       write_mask: Optional[Tensor] = None) -> Tensor:
        """One decode sub-step over the pool → logits [B, V]."""
        return paged_decode_forward(self.params, self.cfg, tok, lens, page_table,
                                    self.pool.k, self.pool.v, attn_impl=self.attn_impl,
                                    write_mask=write_mask)

    # -------------------------------------------------------------- private

    def _prefill_width(self, n_tokens: int) -> int:
        width = bucket_size(
            max(n_tokens, self.page_size),
            tuple(b for b in self.PREFILL_BUCKETS if b % self.page_size == 0)
            or (self.page_size,),
        )
        return ((width + self.page_size - 1) // self.page_size) * self.page_size

    def _admit(self) -> None:
        """Admit queued requests into free slots, then prefill them grouped
        by width bucket, in chunks of up to max(ADMIT_BUCKETS) rows."""
        window = self.max_pages_per_seq * self.page_size
        batch: list[tuple[int, _Request, list[int]]] = []
        for slot_idx, slot in enumerate(self.slots):
            if slot.active or not self._queue:
                continue
            req = self._queue.pop(0)
            # generation gets its tokens up to HALF the window; the prompt
            # always keeps at least the other half
            reserve = min(req.max_new + 2, window // 2)
            tok_ids = self.tokenizer.encode(req.prompt, add_bos=True)[: window - reserve]
            pages = self.allocator.alloc(min(
                (len(tok_ids) + req.max_new + self.page_size - 1) // self.page_size,
                self.max_pages_per_seq))
            batch.append((slot_idx, req, tok_ids))
            slot.request_id = req.request_id
            slot.pages = pages
            slot.prompt_tokens = slot.length = len(tok_ids)
            slot.max_new = req.max_new
            slot.emitted = []
            slot.active = True
            self._page_table[slot_idx] = 0
            self._page_table[slot_idx, : len(pages)] = pages
            self._lens[slot_idx] = len(tok_ids)
            self._temps[slot_idx] = req.temperature

        groups: dict[int, list] = {}
        for item in batch:
            groups.setdefault(self._prefill_width(len(item[2])), []).append(item)
        max_rows = max(self.ADMIT_BUCKETS)
        for width, members in sorted(groups.items()):
            for start in range(0, len(members), max_rows):
                self._prefill_chunk(width, members[start : start + max_rows])

    def _prefill_chunk(self, width: int, chunk: list) -> None:
        """Prefill + scatter + first-token sample for same-width rows, padded
        to a row bucket; split so no dispatch exceeds PREFILL_SCORE_BYTES."""
        score_bytes = self.cfg.n_heads * width * width * 4
        rows_per = max(1, self.PREFILL_SCORE_BYTES // score_bytes)
        if len(chunk) > rows_per:
            for start in range(0, len(chunk), rows_per):
                self._prefill_chunk(width, chunk[start : start + rows_per])
            return
        rows = min(bucket_size(len(chunk), self.ADMIT_BUCKETS), max(rows_per, len(chunk)))
        ids = np.full((rows, width), self.tokenizer.pad_id, np.int64)
        lens = np.ones(rows, np.int64)
        temps = np.zeros(rows, np.float32)
        scat = np.zeros((rows, width // self.page_size), np.int64)
        for r, (slot_idx, req, tok_ids) in enumerate(chunk):
            ids[r, : len(tok_ids)] = tok_ids
            lens[r] = len(tok_ids)
            temps[r] = req.temperature
            used = (len(tok_ids) + self.page_size - 1) // self.page_size
            scat[r, :used] = self.slots[slot_idx].pages[:used]
        last = self.prefill_forward(ids, lens, scat)
        first, first_lp = sample_tokens(last, self._gen, temps)
        first = first.cpu().numpy()
        first_lp = first_lp.cpu().numpy()
        for r, (slot_idx, _req, _t) in enumerate(chunk):
            self._last_tok[slot_idx] = int(first[r])
            self._lp_sum[slot_idx] = self._lp_min[slot_idx] = first_lp[r]
            self._lp_cnt[slot_idx] = 1
            result = self._fold_and_maybe_retire(slot_idx)
            if result is not None:
                self._finished.append(result)

    def _tick(self) -> None:
        """Per-row budgets, then up to ``steps`` fused decode sub-steps,
        one host fetch, and the host replay of the device halting rule."""
        remaining = np.zeros(self.max_slots, np.int32)
        for i, slot in enumerate(self.slots):
            if not slot.active:
                continue
            capacity = len(slot.pages) * self.page_size
            remaining[i] = max(min(slot.max_new - len(slot.emitted),
                                   capacity - 1 - slot.length), 0)
            if remaining[i] == 0:
                self._finished.append(self._retire(i, "length"))
        # an idle queue runs the big tick; waiting requests shrink it so
        # freed slots refill sooner
        waiting = len(self._queue)
        if waiting == 0:
            steps = self.max_tick_steps
        else:
            shrink = 1 << min(waiting // max(self.max_slots, 1), 2)
            steps = max(self.steps_per_tick // shrink, 2)
        budgets = np.minimum(remaining, steps).astype(np.int32)
        n_steps = int(budgets.max())
        if n_steps == 0:
            return

        dev = self.device
        tok = torch.as_tensor(self._last_tok, device=dev)
        lens = torch.as_tensor(self._lens, device=dev)
        table = torch.as_tensor(self._page_table, device=dev)
        budgets_t = torch.as_tensor(budgets, device=dev)
        halted = torch.zeros(self.max_slots, dtype=torch.bool, device=dev)
        lp_sum = torch.as_tensor(self._lp_sum, device=dev)
        lp_min = torch.as_tensor(self._lp_min, device=dev)
        lp_cnt = torch.as_tensor(self._lp_cnt, device=dev)
        temps = self._temps.copy()
        sampled = []
        for idx in range(n_steps):
            active = (~halted) & (idx < budgets_t)
            logits = self.decode_forward(tok, lens, table, write_mask=active)
            nxt, lp = sample_tokens(logits, self._gen, temps)
            tok = torch.where(active, nxt, tok)
            lens = torch.where(active, lens + 1, lens)
            lp_sum = torch.where(active, lp_sum + lp, lp_sum)
            lp_min = torch.where(active, torch.minimum(lp_min, lp), lp_min)
            lp_cnt = torch.where(active, lp_cnt + 1, lp_cnt)
            halted = halted | (active & (nxt == self.tokenizer.eos_id))
            sampled.append(nxt)
        self.total_sub_steps += n_steps
        # the one host fetch of the tick
        toks = torch.stack(sampled).cpu().numpy()
        lp_state = torch.stack([lp_sum, lp_min, lp_cnt.float()]).cpu().numpy()

        for i, slot in enumerate(self.slots):
            n = int(budgets[i])
            if not slot.active or n == 0:
                continue
            self._lp_sum[i], self._lp_min[i] = lp_state[0, i], lp_state[1, i]
            self._lp_cnt[i] = int(lp_state[2, i])
            for s in range(n):
                slot.length += 1
                self._lens[i] = slot.length
                self._last_tok[i] = int(toks[s, i])
                result = self._fold_and_maybe_retire(i)
                if result is not None:
                    self._finished.append(result)
                    break

    def _fold_and_maybe_retire(self, i: int) -> Optional[PagedResult]:
        """Fold ``_last_tok[i]`` into slot ``i``; retire on EOS / token
        budget / page capacity — the one place these conditions live."""
        slot = self.slots[i]
        tok = int(self._last_tok[i])
        hit_eos = tok == self.tokenizer.eos_id
        if not hit_eos:
            slot.emitted.append(tok)
        hit_len = len(slot.emitted) >= slot.max_new
        out_of_pages = slot.length + 1 >= len(slot.pages) * self.page_size
        if hit_eos or hit_len or out_of_pages:
            return self._retire(i, "stop" if hit_eos else "length")
        return None

    def _retire(self, i: int, reason: str) -> PagedResult:
        slot = self.slots[i]
        result = PagedResult(
            request_id=slot.request_id,
            text=self.tokenizer.decode(slot.emitted),
            tokens=list(slot.emitted),
            prompt_tokens=slot.prompt_tokens,
            finish_reason=reason,
            logprob_sum=float(self._lp_sum[i]),
            logprob_min=float(self._lp_min[i]),
            logprob_count=int(self._lp_cnt[i]),
        )
        self.allocator.free(slot.pages)
        slot.active = False
        slot.pages = []
        self._page_table[i] = 0
        self._lens[i] = 0
        self._temps[i] = 0.0
        self._last_tok[i] = 0
        self._lp_sum[i] = self._lp_min[i] = 0.0
        self._lp_cnt[i] = 0
        return result
