"""Speculative decoding: draft-and-verify generation, exact by construction —
the counterpart of ``sentio_tpu/runtime/speculative.py``.

A small draft model proposes ``k`` tokens one at a time; the target scores
all of them in ONE forward of T = k+1, so its weights stream once for up to
k+1 emitted tokens. Two acceptance rules:

* **greedy (temperature 0)** — the longest prefix where the target's own
  argmax agrees with the draft, then the target's correction token: the
  same tokens as target-only greedy decoding;
* **sampled (temperature > 0)** — rejection sampling
  (:func:`accept_and_correct`): each emitted token's marginal equals
  sampling the target alone at that temperature.

Cache discipline as in JAX: both models write k/v at absolute positions;
rejected positions hold stale entries past each row's accepted length,
which no query attends (the causal mask is by position) and the next round
overwrites at the same offsets, so rollback copies nothing.

:func:`spec_generate` runs JAX's fused program as an eager loop: both
models prefill through the engine's ``attn_fn`` (the causal flash kernel
on the card), then draft(k) + verify(k+1) + accept rounds until every row
is done, the host reading the rows' ``done`` once a round. Randomness comes
from an explicit ``torch.Generator``, so sampled paths agree with JAX in
distribution only. The paged engine's spec tick (:mod:`.paged_spec`) runs
the same round over its slot batch.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import torch

from sentio_tpu_torch.models.llama import LlamaConfig, init_cache, llama_forward

Tensor = torch.Tensor


class SpeculativeError(Exception):
    pass


def categorical(generator: Optional[torch.Generator], logits: Tensor) -> Tensor:
    """One draw per row from ``softmax(logits)`` [B, V] (Gumbel-max over
    uniform draws, as :func:`~.sampling.sample_tokens` samples) → [B] int64."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    return (logits - torch.log(-torch.log(u.clamp_min(1e-20)))).argmax(dim=-1)


def accept_and_correct(generator: Optional[torch.Generator], drafts: Tensor,
                       qdists: Tensor, tprobs: Tensor) -> tuple[Tensor, Tensor]:
    """Rejection-sampling acceptance for sampled speculation.

    drafts [B, k] proposed tokens; qdists [B, k, V] the draft's sampling
    distributions; tprobs [B, k+1, V] the target's distributions at the
    verified positions. Accept d_j with probability min(1, p_t(d_j)/q(d_j))
    while the prefix holds; at the first rejection draw the correction from
    the residual ``norm(relu(p_t - q))``, and after a full accept draw the
    bonus token from the target's (k+1)-th distribution. Identical target
    and draft distributions leave a zero residual: the correction then comes
    from the target's distribution. The emitted marginal equals sampling the
    target alone.

    Returns (n_accept [B], correction [B]), both int64."""
    b, k = drafts.shape
    u = torch.rand((b, k), generator=generator, device=drafts.device)
    p_chosen = tprobs[:, :k].gather(2, drafts[..., None])[..., 0]
    q_chosen = qdists.gather(2, drafts[..., None])[..., 0]
    acc = u < (p_chosen / q_chosen.clamp_min(1e-20)).clamp_max(1.0)
    n_accept = acc.long().cumprod(dim=1).sum(dim=1)

    # the correction's distribution at position j* = n_accept
    resid = (tprobs[:, :k] - qdists).clamp_min(0.0)
    resid_full = torch.cat([resid, tprobs[:, k:]], dim=1)
    at = n_accept[:, None, None].expand(b, 1, tprobs.shape[-1])
    sel = resid_full.gather(1, at)[:, 0]
    norm = sel.sum(dim=-1, keepdim=True)
    tsel = tprobs.gather(1, at)[:, 0]
    dist = torch.where(norm > 1e-9, sel / norm.clamp_min(1e-9), tsel)
    return n_accept, categorical(generator, torch.log(dist + 1e-20))


def draft_round(params_d: dict, dcfg: LlamaConfig, dcache: dict, cur: Tensor, lens: Tensor,
                k: int, scaled=None) -> tuple[Tensor, Optional[Tensor]]:
    """The draft's k+1 autoregressive T=1 steps from ``cur`` at ``lens``
    (the last step only for its k/v write at ``lens + k``, which a fully
    accepted round advances past: without it the draft cache keeps an
    unwritten, attended slot). ``scaled`` (None = greedy) maps a step's
    logits [B, V] to ``(next tokens, the distribution they were drawn
    from)``. → (drafts [B, k], qdists [B, k, V] or None)."""
    drafts, qdists = [], []
    tok, dlens = cur, lens
    for _ in range(k + 1):
        logits, _ = llama_forward(params_d, dcfg, tok[:, None], positions=dlens[:, None],
                                  cache=dcache, cache_index=dlens)
        last = logits[:, -1]
        if scaled is None:
            tok = last.argmax(dim=-1)
        else:
            tok, qdist = scaled(last)
            qdists.append(qdist)
        drafts.append(tok)
        dlens = dlens + 1
    return (torch.stack(drafts[:k], dim=1),
            torch.stack(qdists[:k], dim=1) if qdists else None)


def verify_logits(params_t: dict, tcfg: LlamaConfig, tcache: dict, cur: Tensor, drafts: Tensor,
                  lens: Tensor) -> Tensor:
    """The target's one T=k+1 forward over ``[cur, d1..dk]`` at ``lens``
    (plain attention over the cache, as JAX's verify) → logits [B, k+1, V]."""
    block = torch.cat([cur[:, None], drafts], dim=1)
    pos = lens.long()[:, None] + torch.arange(block.shape[1], device=block.device)[None, :]
    logits, _ = llama_forward(params_t, tcfg, block, positions=pos, cache=tcache,
                              cache_index=lens)
    return logits


def greedy_accept(drafts: Tensor, t_logits: Tensor) -> tuple[Tensor, Tensor]:
    """The longest prefix where each draft equals the target's argmax of
    the position before it, and the target's token after that prefix →
    (n_accept [B], correction [B])."""
    k = drafts.shape[1]
    targets = t_logits.argmax(dim=-1)
    n_accept = (drafts == targets[:, :k]).long().cumprod(dim=1).sum(dim=1)
    return n_accept, targets.gather(1, n_accept[:, None])[:, 0]


def round_tokens(drafts: Tensor, n_accept: Tensor, correction: Tensor, eos_id: int) -> Tensor:
    """A round's tokens [B, k+1]: d1..dm, the correction, EOS after."""
    j = torch.arange(drafts.shape[1] + 1, device=drafts.device)[None, :]
    padded = torch.cat([drafts, torch.full_like(drafts[:, :1], eos_id)], dim=1)
    return torch.where(j < n_accept[:, None], padded,
                       torch.where(j == n_accept[:, None], correction[:, None], eos_id))


def write_tokens(out: Tensor, toks: Tensor, offset: Tensor, n: Tensor) -> None:
    """``out[b, offset[b] + j] = toks[b, j]`` for j < n[b], in place. Each
    output column picks its own source, so no write is clamped or shifted
    (JAX's ``dynamic_update_slice`` would clamp a start that overhangs)."""
    col = torch.arange(out.shape[1], device=out.device)[None, :] - offset.long()[:, None]
    src = toks.gather(1, col.clamp(0, toks.shape[1] - 1))
    out.copy_(torch.where((col >= 0) & (col < n.long()[:, None]), src, out))


def spec_generate(params_t: dict, tcfg: LlamaConfig, params_d: dict, dcfg: LlamaConfig,
                  ids: Tensor, positions: Tensor, lens: Tensor, tcache: dict, dcache: dict,
                  steps: int, k: int, pad_mask: Tensor, generator: Optional[torch.Generator],
                  temperature: float, eos_id: int, attn_fn=None) -> tuple[Tensor, Tensor, int]:
    """Both prefills, the first token, then rounds until every row is done
    → (out [B, steps + k + 1] int64, emitted [B], rounds). ``steps`` bounds
    each row's emitted tokens (a round may overrun it by up to k); junk
    bucket rows (no real cell in ``pad_mask``) start done."""
    b = ids.shape[0]
    sampled = temperature > 0.0
    row_valid = pad_mask.any(dim=1)
    # prefill both models over the prompt through attn_fn: the engine's own
    # prefill numerics (kernel and plain attention can flip an argmax tie)
    t_logits, _ = llama_forward(params_t, tcfg, ids, positions=positions, cache=tcache,
                                cache_index=0, pad_mask=pad_mask, attn_fn=attn_fn)
    llama_forward(params_d, dcfg, ids, positions=positions, cache=dcache, cache_index=0,
                  pad_mask=pad_mask, attn_fn=attn_fn)
    rows = torch.arange(b, device=ids.device)
    last = t_logits[rows, lens.long() - 1]
    del t_logits
    cur = categorical(generator, last / temperature) if sampled else last.argmax(dim=-1)

    out = torch.full((b, steps + k + 1), eos_id, dtype=torch.int64, device=ids.device)
    out[:, 0] = cur
    # emitted[b] counts tokens written for row b; cur sits at cache position
    # lens[b] and is emitted at offset 0
    emitted = torch.ones(b, dtype=torch.int64, device=ids.device)
    done = (cur == eos_id) | ~row_valid
    lens = lens.long()

    def scaled(last: Tensor) -> tuple[Tensor, Tensor]:
        logits = last / temperature
        return categorical(generator, logits), torch.softmax(logits, dim=-1)

    j = torch.arange(k + 1, device=ids.device)[None, :]
    rounds = 0
    while not bool(done.all()):
        drafts, qdists = draft_round(params_d, dcfg, dcache, cur, lens, k,
                                     scaled if sampled else None)
        t_logits = verify_logits(params_t, tcfg, tcache, cur, drafts, lens)
        if sampled:
            tprobs = torch.softmax(t_logits / temperature, dim=-1)
            n_accept, correction = accept_and_correct(generator, drafts, qdists, tprobs)
        else:
            n_accept, correction = greedy_accept(drafts, t_logits)
        toks = round_tokens(drafts, n_accept, correction, eos_id)
        # EOS inside the accepted run ends the row's emission
        is_eos = toks == eos_id
        before_eos = is_eos.long().cumsum(1).cumsum(1) <= 1
        emit_n = torch.minimum(n_accept + 1, before_eos.sum(dim=1))
        hit_eos = (is_eos.long().cumsum(1) > 0) & (j < emit_n[:, None])
        row_done = done | hit_eos.any(dim=1)
        emit_n = torch.where(done, 0, emit_n)
        write_tokens(out, toks, emitted, emit_n)
        cur = torch.where(done, cur, correction)
        lens = lens + emit_n
        emitted = emitted + emit_n
        # a row retires at EOS or once its own budget is spent
        done = row_done | (emitted >= steps)
        rounds += 1
    return out, emitted, rounds


class SpeculativeDecoder:
    """Draft-model wrapper for a :class:`~.engine.GeneratorEngine` target.

    Temperature 0: ``generate`` emits the target engine's greedy tokens.
    Temperature > 0: each emitted token is distributed as sampling the
    target alone. The ``k`` drafted tokens per round only change how many
    target weight streams a token costs; ``stats`` / ``tokens_per_round``
    say whether the draft earns its keep. ``prefills`` counts the prefills
    this decoder ran itself (a target's and a draft's per call)."""

    def __init__(self, engine, draft_params: dict, draft_config: LlamaConfig, k: int = 4,
                 draft_fwd=None) -> None:
        if draft_fwd is not None or not isinstance(draft_config, LlamaConfig):
            raise NotImplementedError("SpeculativeDecoder: a MoE draft (draft_fwd) is not "
                                      "ported")
        if draft_config.vocab_size != engine.model_config.vocab_size:
            raise SpeculativeError(
                f"draft vocab {draft_config.vocab_size} != target "
                f"{engine.model_config.vocab_size} — same tokenizer required")
        if k < 1:
            raise SpeculativeError(f"k must be >= 1, got {k}")
        self.engine = engine
        self.draft_params = draft_params
        self.draft_config = draft_config
        self.k = int(k)
        self.stats = {"rounds": 0, "tokens": 0}
        self.prefills = 0

    def generate(self, prompts: Sequence[str], max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0):
        """Batched generation through the speculative loop: greedy tokens
        equal ``engine.generate(temperature=0)``'s; sampled tokens follow
        the target's law. A prompt so near the end of its window that the
        verify block's k+1 spill would shorten its budget goes to
        ``engine.generate``, so this path never returns fewer tokens."""
        from sentio_tpu_torch.runtime.engine import GenerationResult

        eng = self.engine
        t0 = time.perf_counter()
        requested = max_new_tokens or eng.config.max_new_tokens
        ids, positions, lens, tcache, n, window, pad_mask = eng._encode_batch(
            prompts, requested + self.k + 1)
        headroom = window - int(lens.max())
        plain_steps = eng._stable_steps(requested, headroom)
        spec_steps = eng._stable_steps(requested, max(headroom - self.k - 1, 1))
        if spec_steps < plain_steps:
            return eng.generate(prompts, max_new_tokens=requested, temperature=temperature)
        dcache = init_cache(self.draft_config, ids.shape[0], window, eng.device)
        self.prefills += 2
        out, emitted, rounds = spec_generate(
            eng.params, eng.model_config, self.draft_params, self.draft_config,
            eng._tensor(ids), eng._tensor(positions), eng._tensor(lens), tcache, dcache,
            spec_steps, self.k, eng._tensor(pad_mask, torch.bool),
            eng._gen if temperature > 0.0 else None, float(temperature),
            eng.tokenizer.eos_id, attn_fn=eng.attn_fn)
        out, emitted = out.cpu().numpy(), emitted.cpu().numpy()
        self.stats["rounds"] += rounds
        self.stats["tokens"] += int(emitted[:n].sum())

        eos = eng.tokenizer.eos_id
        dt_ms = (time.perf_counter() - t0) * 1000.0
        results = []
        for i in range(n):
            # the steps bucket rounds UP; the tail past the caller's budget
            # is dropped, as engine.generate drops it
            row = out[i, : min(int(emitted[i]), spec_steps, requested)].tolist()
            if eos in row:
                row, reason = row[: row.index(eos)], "stop"
            else:
                reason = "length"
            results.append(GenerationResult(text=eng.tokenizer.decode(row), tokens=row,
                                            prompt_tokens=int(lens[i]), finish_reason=reason,
                                            latency_ms=dt_ms))
        return results

    @property
    def tokens_per_round(self) -> float:
        """Mean emitted tokens per target verify: 1.0 means the draft never
        helps; k+1 is the ceiling."""
        return self.stats["tokens"] / max(self.stats["rounds"], 1)
