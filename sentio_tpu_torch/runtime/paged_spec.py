"""Speculative decoding inside the paged continuous-batching engine — the
counterpart of ``sentio_tpu/runtime/paged_spec.py``.

With a draft model every decode tick of the engine is a spec tick, over the
whole slot batch, so continuous batching and speculation compose: rows
join and leave between ticks, and the page tables stay the source of truth.

One tick (:class:`SpecTick`):

1. **densify** — each row's page table is gathered into a contiguous
   ``[L, S, W, Hkv, D]`` cache over the full window (an int8 pool is
   dequantized on the way in);
2. **rounds** — draft(k) + verify(k+1) + accept rounds, the math of
   :mod:`.speculative` (greedy rows: the longest agreeing prefix, the plain
   engine's tokens; sampled rows: rejection sampling), both rules selected
   per row by temperature, so mixed batches serve correctly. Per-row tick
   budgets cap each round's emission before EOS is looked at, and EOS
   halts a row only inside that capped window. Each round reads and updates
   the engine's decode state in place (``tok``, ``lens``, ``halted``) and
   this object's own buffers, so on the card one CUDA graph of it replays
   against the same addresses every round; the host reads the rows' ``done``
   once a round (a ``while`` cannot live in a graph);
3. **scatter back** — the dense cache goes back into the pool through
   :func:`~.paged.scatter_prefill`, one layer at a time (an int8 pool is
   quantized again).

The tick's one fetch is the packed ``[S, out_w + 3]`` block: column 0
echoes the tick's input token (a freshly admitted row's first token reaches
the host in it), column 1 the emitted count, column 2 the verify count,
then the tokens.

As in JAX, a verify block writes KV up to ``spec_k + 1`` positions past a
row's accepted length, so admission reserves that headroom in each row's
pages; a request already at ``max_pages_per_seq`` pays it from its budget
and may finish up to ``spec_k + 1`` tokens earlier than the plain engine.
Within a tick the verify attends the rounds' KV unquantized, so spec output
on an int8 pool differs from the plain int8 engine's within quantization
noise.
"""

from __future__ import annotations

from typing import Optional

import torch

from sentio_tpu_torch.kernels.paged_attention import QuantPages
from sentio_tpu_torch.models.llama import LlamaConfig, init_cache, llama_forward
from sentio_tpu_torch.runtime.paged import PagedPool, dequantize_kv, scatter_prefill
from sentio_tpu_torch.runtime.speculative import (
    accept_and_correct,
    categorical,
    draft_round,
    greedy_accept,
    round_tokens,
    verify_logits,
    write_tokens,
)

Tensor = torch.Tensor


def _layer_slice(pages, layer: int):
    """Layer ``layer`` of a pool's k or v as a one-layer view, ``[1, ...]``."""
    if isinstance(pages, QuantPages):
        return QuantPages(pages.q[layer:layer + 1], pages.s[layer:layer + 1])
    return pages[layer:layer + 1]


class SpecTick:
    """The spec tick of one engine: its buffers, which never move, and its
    steps. ``tcache`` is the densified target cache ``[L, S, W, Hkv, D]``,
    ``dcache`` the draft's persistent cache ``[Ld, S, W, Hkv_d, D_d]``
    (filled by :meth:`draft_prefill` at admission over each row's full
    prompt: prefix pages are target-only). ``out_w`` is the widest tick's
    ``steps + k + 1``."""

    def __init__(self, cfg: LlamaConfig, params: dict, dcfg: LlamaConfig, params_d: dict,
                 k: int, max_slots: int, window: int, out_w: int, eos_id: int,
                 ignore_eos: bool, device) -> None:
        self.cfg, self.params, self.dcfg, self.params_d = cfg, params, dcfg, params_d
        self.k, self.eos_id, self.ignore_eos = k, eos_id, ignore_eos
        self.tcache = init_cache(cfg, max_slots, window, device)
        self.dcache = init_cache(dcfg, max_slots, window, device)

        def zeros(*shape, dtype=torch.int64):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.echo = zeros(max_slots)
        self.emitted = zeros(max_slots)
        self.rounds = zeros(max_slots)  # verifies per row this tick
        self.done = zeros(max_slots, dtype=torch.bool)
        self.out = zeros(max_slots, out_w)

    @property
    def dense_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.tcache.values())

    @property
    def draft_bytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self.dcache.values())

    def zero_(self) -> None:
        for t in (*self.tcache.values(), *self.dcache.values(), self.echo, self.emitted,
                  self.rounds, self.done, self.out):
            t.zero_()

    def draft_prefill(self, ids: Tensor, rows: Tensor, n: int) -> None:
        """Prefill the draft over ``ids`` [b, W] (plain attention, as JAX's
        draft prefill) and write the first ``n`` rows' caches into the draft
        cache rows ``rows`` [n]; pad rows are dropped."""
        b, width = ids.shape
        cache = init_cache(self.dcfg, b, width, ids.device)
        positions = torch.arange(width, device=ids.device)[None, :].expand(b, width)
        llama_forward(self.params_d, self.dcfg, ids, positions=positions, cache=cache,
                      cache_index=0)
        for name in ("k", "v"):
            self.dcache[name][:, rows, :width] = cache[name][:, :n]

    def begin(self, st, pool: PagedPool) -> None:
        """Start a tick on the engine's decode state ``st`` (admitted rows
        already merged): echo the input tokens, densify the pool by
        ``st.table`` and clear the round state. Rows halted or without
        budget start done."""
        self.echo.copy_(st.tok)
        table = st.table.long().reshape(-1)
        dtype = self.cfg.torch_dtype
        for pages, dense in ((pool.k, self.tcache["k"]), (pool.v, self.tcache["v"])):
            lcount, _s, _w, hkv, hd = dense.shape
            blocks = dense.view(lcount, table.shape[0], pool.page_size, hkv, hd)
            for layer in range(lcount):
                if isinstance(pages, QuantPages):
                    blocks[layer].copy_(dequantize_kv(pages.q[layer].index_select(0, table),
                                                      pages.s[layer].index_select(0, table),
                                                      dtype))
                else:
                    torch.index_select(pages[layer], 0, table, out=blocks[layer])
        self.emitted.zero_()
        self.rounds.zero_()
        self.out.fill_(self.eos_id)
        self.done.copy_(st.halted | (st.budgets <= 0))

    def round(self, st, all_greedy: bool, generator: Optional[torch.Generator]) -> None:
        """One draft/verify/accept round over the slot batch, in place. Rows
        done at its start move nothing. ``all_greedy`` skips the sampled
        rule's work; otherwise rows with temperature > 0 draw from
        ``generator``. Reads nothing back to the host, so it can be
        captured in a CUDA graph."""
        k, eos, done = self.k, self.eos_id, self.done
        entry_live = ~done
        scaled = None
        if not all_greedy:
            sampled_row = st.temps > 0.0
            temps = st.temps.clamp_min(1e-6)[:, None]

            def scaled(last: Tensor) -> tuple[Tensor, Tensor]:
                logits = last / temps
                tok = torch.where(sampled_row, categorical(generator, logits),
                                  last.argmax(dim=-1))
                return tok, torch.softmax(logits, dim=-1)

        drafts, qdists = draft_round(self.params_d, self.dcfg, self.dcache, st.tok, st.lens,
                                     k, scaled)
        t_logits = verify_logits(self.params, self.cfg, self.tcache, st.tok, drafts, st.lens)
        n_accept, correction = greedy_accept(drafts, t_logits)
        if not all_greedy:
            tprobs = torch.softmax(t_logits / temps[:, :, None], dim=-1)
            n_s, corr_s = accept_and_correct(generator, drafts, qdists, tprobs)
            n_accept = torch.where(sampled_row, n_s, n_accept)
            correction = torch.where(sampled_row, corr_s, correction)
        del t_logits
        toks = round_tokens(drafts, n_accept, correction, eos)

        j = torch.arange(k + 1, device=toks.device)[None, :]
        # the row's tick budget first: verified tokens past it are dropped
        # (decoded again next tick). EOS counts only inside the capped
        # window: an EOS past the cap was never emitted, so it must neither
        # halt the row nor truncate it
        emit_n = torch.minimum(n_accept + 1, st.budgets.long() - self.emitted)
        emit_n = torch.where(done, 0, emit_n.clamp_min(0))
        if not self.ignore_eos:
            eos_in = (toks == eos) & (j < emit_n[:, None])
            # positions up to and including the first EOS in the window
            thru_eos = eos_in.long().cumsum(1).cumsum(1) <= 1
            emit_n = torch.minimum(emit_n, (thru_eos & (j < emit_n[:, None])).sum(dim=1))
            st.halted.copy_(st.halted | (entry_live & eos_in.any(dim=1)))
        write_tokens(self.out, toks, self.emitted, emit_n)
        last = toks.gather(1, (emit_n - 1).clamp_min(0)[:, None])[:, 0]
        st.tok.copy_(torch.where(emit_n > 0, last, st.tok))
        st.lens.add_(emit_n.to(st.lens.dtype))
        self.emitted.add_(emit_n)
        done.copy_(done | st.halted | (self.emitted >= st.budgets))
        # a row live at the round's start ran one verify
        self.rounds.add_(entry_live.long())

    def end(self, st, pool: PagedPool) -> None:
        """Scatter the dense cache back into the pool, one layer at a time
        (an int8 pool's quantization works on a layer's float copy)."""
        table = st.table.long()
        for layer in range(self.cfg.n_layers):
            scatter_prefill(_layer_slice(pool.k, layer), _layer_slice(pool.v, layer),
                            self.tcache["k"][layer:layer + 1],
                            self.tcache["v"][layer:layer + 1], table)

    def packed(self) -> Tensor:
        """``[S, out_w + 3]``: echo, emitted, verifies, then the tokens."""
        return torch.cat([self.echo[:, None], self.emitted[:, None], self.rounds[:, None],
                          self.out], dim=1)

