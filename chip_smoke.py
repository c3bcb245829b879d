#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sentio_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one JSON
line each:

1. device — the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build — the three CUDA kernels built from csrc/ with nvcc, in parallel
   with both paged kernels' sources at the other span sizes of their
   sweeps, with each kernel library's count of tensor-core instructions
   (HGMMA, HMMA) in its SASS (the flash kernel must have HGMMA, the int8
   paged kernel HMMA), and the BM25 core with g++
   (host code; without a compiler the hybrid retriever scores with numpy,
   as the JAX package does, and the phase says which backend ran).
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it (bf16-output kernel vs float32 plain
   on the same inputs: max abs error <= 2e-2 and mean <= 2e-3, since bf16
   outputs carry ~3 significant digits and the sums run in another order),
   timed beside its plain version, the bound the card could reach, and one
   PyTorch call computing the same function (scaled_dot_product_attention,
   a yardstick only, unmasked where every key is attended). Each paged
   kernel (bf16 and int8) runs at the serving batch's ragged lengths and at
   a chat's decode shape (one live row, seven idle), each with its
   pages-per-span sweep (one build of the source per span size; the int8
   kernel's blocks per SM too); the flash kernel at the embedder's and
   cross-encoder's shapes and at ingest's full lengths. Both paged kernels
   also run at the eval engine's shape (B 8, H 8, Hkv 4, D 64, 16-token
   pages, 128 a row; rows of 1, 17 and 2,048 keys): a page is half of the
   kernels' 32-row chunk, and the other half must never be read.
   Kernel and SDPA times are device times: 20 calls captured in a CUDA
   graph and replayed, so the host's launch cost is not counted.
4. slice — the /chat pipeline at full width (Llama-3-8B, the base
   embedder, the default cross-encoder) with random weights made on the
   card from a seed, dense retrieval and bf16 pages, under the engine's
   serving defaults (radix prefix cache, pipeline depth 2, each decode
   sub-step a CUDA graph replay): ingest 2,048 chunks, then answer 3 chats
   with every launch count set to 0 just before and read just after. Each
   chat reports its generate and verify admissions (prefix-hit against
   prefilled tokens) and the graphs' captures, replays and capture seconds.
   Gates: the bf16 paged kernel ran once per layer per decode sub-step
   (counted through the graph replays), the flash kernel too, the int8
   kernel never, each wrapper's count equal to the card's own count of its
   device functions (every kernel adds one to a device-side counter as it
   starts), and every chat's verify admission hit the radix tree.
5. logits — one prompt's prefill and 4 teacher-forced decode steps through
   the kernel path and the plain path.
6. graph — the generate prompt of chat 1, greedy, decoded from graph
   replays and from the same sub-step run eagerly on the card, over the
   same cached prefix: the tokens must be equal.
7. chunked_slice — one chunked admission (PREFILL_CHUNK=512) of a fresh
   ~3,000-token prompt on the slice's own engine, pool, kernels and graphs:
   prefilled and hit tokens make the prompt, several segments, the pool's
   paged kernel once per layer per replayed sub-step.
8. profile — one more chat under the CUDA profiler: device time by kernel
   family (and by each hand-written device function), the device's idle
   share, and the card's own launch counts: the pool's paged split kernel
   and its combine must each have run once per layer per sub-step, the
   other paged family never, the flash kernel as often as its wrapper
   counted. The profiler's counts are reported beside them; it can drop
   records, so they are held only to no more than the card's.
9. slice_int8 — a second pipeline under the default settings plus
   KV_QUANT=int8 (hybrid retrieval: dense + BM25 fused by rrf), on the same
   weight tensors with its own int8 page pool: the same ingest, chats and
   gates with the int8 kernel in the bf16 kernel's place, and the BM25
   leg's hits in every fused list.
10. logits_int8 — phase 5 on the int8 engine, and (reported, not gated)
   how far its logits lie from the bf16 engine's on the same forced tokens:
   quantization's own error.
11. graph_int8, chunked_slice_int8, profile_int8 — phases 6–8 on the int8
    pipeline.
12. chunked — the generate prompt of chat 1 (~3,300 tokens) admitted with
    PREFILL_CHUNK=512 and whole, greedy: the same tokens and the same
    prefilled token count. In float32 at Llama-3-8B width cut to 2 layers,
    with the plain decode attention (the paged kernels take bf16): two
    prefills of different shapes round differently in bf16, which can flip
    a near-tied greedy token of a random-weight model, and the point here
    is the admission, not the kernels.

13. slice_spec — speculative decoding at full width and depth: a pipeline
    under the default settings (hybrid rrf, bf16 pool, prefix cache, depth
    2) with bench.py phase E's draft (dim 2048, 4 layers, 16 / 4 heads, MLP
    7,168, random from the seed) passed to ``build_pipeline``, k 4, on the
    slices' Llama-3-8B tensors (the earlier pipelines' pools freed first).
    Warmup captures both spec round variants. 3 chats in a counted window
    (generate at 0.3, the rejection rule; verify at 0, the greedy rule),
    then 4 at once through the service (``slice_spec_service``) and one
    under the profiler (``profile_spec``). Gates: no chat degraded, no
    paged kernel launched (every decode tick a spec tick), flash equal to
    the card's count, spec verifies with 1 to k+1 tokens each, no capture
    after warmup, every round a graph replay. Reported: rounds, replays,
    tokens per verify, the densified and draft-cache bytes, peak memory.
14. spec_int8 — KV_QUANT=int8 with the draft, the target cut to 4 layers:
    3 greedy chats, no paged kernel; reported: how many codes and scales
    of pages wholly before each tick's first write the dequantize /
    quantize round trip changed, and how many greedy tokens of a bf16 spec
    engine agree with a bf16 plain engine's before the first difference.
15. spec_exact — float32 at Llama-3-8B width cut to 2 layers, 4 prompts of
    64 tokens, 64 new tokens each, greedy, on both engines with a perfect
    draft (the target's own tensors) and a weak one (phase E's geometry at
    2 layers): every spec run's tokens equal its engine's plain tokens, the
    perfect draft gives at least k tokens a verify on both engines;
    then the contiguous decoder in bf16: its target and draft prefills
    launch flash once per layer each, the card's count the same.
16. train_encoder — the bi-encoder trained in-tree at train-encoder's CLI
    defaults (dim 256, 4 layers, 600 steps of 64 pairs; float32 masters,
    bf16 compute, AdamW): loss at step 0 and at the end, median step ms,
    peak memory, recall@10 on the eval bundle trained and untrained (the
    serving embedder: flash launches held to the card's). Gates: the loss
    fell, trained recall above untrained, the checkpoint reads back equal
    and serves through EMBEDDER_CHECKPOINT in build_pipeline.
17. train_encoder_wide — 20 steps at the serving embedder's width (dim
    1,024, 24 layers) in bf16 compute (step ms, peak memory) and in
    float32 from the same masters: every loss finite, step 0's losses
    agree, every layer trained (the losses reported: JAX's recipe
    collapses at this depth within these steps).
18. eval — run_eval at bench scale and its defaults (1,024 documents, 64
    queries, concurrency 8, 48 new tokens) with the trained encoder: the
    five rows, the loopback baseline and the north star; each
    configuration's kernel launches counted (flash in dense and
    hybrid_rerank, the bf16 paged kernel in full_paged and batched), each
    equal to the card's; every row 64 queries and no error.
19. quality_gates — full_paged over 16 queries: bf16 against int8 held to
    eval/quant_gate.json (the int8 run through the int8 kernel), sync
    against gated held to eval/verify_gate.json.
20. verify_modes — VERIFY_MODE on the HTTP server at Llama-3-8B width
    (Settings(): hybrid, bf16 pool), the mode switched between rounds:
    sync; async (each JSON chat back with verify_pending, its verdict in
    /debug/flight/{id} within 30 s; an SSE chat's [DONE] before its verify
    event); gated at 0.75 (skip rate reported) and at 0 (every verdict
    skipped_confident, no verify admission). Reported: time to the answer
    under each mode against sync's.

21. replicas_1, replicas_2 — the replica tier behind the HTTP server at
    full width (``Settings()`` with REPLICAS=1, then 2): warmup of every
    replica at once (seconds, each
    replica's captures), then 3 rounds of 8 JSON and 2 SSE chats at once
    from tenants ``a`` and ``b`` (X-Tenant), each round in a counted window
    and on questions of its own, with AFFINITY_STICKINESS 0.5: the router
    takes the first of replicas tied at the best prefix hit, as JAX's does,
    every burst prompt ties them (the same first 512 tokens), and replica 0
    keeps them while its backlog is within 0.5 x its slots, the rest going
    to the least loaded. Gates, in each round: no chat degraded, each
    replica served a chat, every verify admission a radix hit on its
    replica, one bf16 paged launch per layer per sub-step of every replica
    (the card's count the same), no capture, no tenant reservation
    pending; ``/health`` healthy, a ``sentio_tpu_replica_stat`` row set per
    replica, ``/info`` naming the count. Reported: each round's p50 / p95 and those of all 30 chats at
    each count, each replica's duty cycle, peak memory.
22. replica_rebuild — on the two replicas: replica 0's ticks fail (a fault
    point on its engine's step) until its breaker trips (3 tick failures):
    quarantine, then a rebuild that frees the old pool and graphs and warms
    a fresh engine (every variant captured) while JSON chats keep coming.
    Gates: every chat answered, those back while replica 0 was out of
    rotation by replica 1; ``/health`` degraded then healthy with one
    rebuild; the launch counts equal to the card's over the whole phase.
    Reported: rebuild seconds, peak memory.
23. replica_stall — replica 0's pump wedges in a tick (a stall event): the
    watchdog (TICK_STALL_BUDGET_S 5 s for the phase) quarantines it, its
    admitted request fails typed,
    its 3 queued requests are handed to replica 1 and answered; the wedged
    pump is counted leaked (its pool kept), the replica is rebuilt beside
    it, then the event is released. Reported: pump_leaked, peak memory.
24. stream_resume — a greedy stream whose replica dies (``paged.step``)
    right after its first delivered piece resumes on the survivor: in
    float32 at Llama-3-8B width cut to 2 layers with the plain decode
    attention (two engines behind a set), the text must equal an
    uninterrupted run's; in bf16 at full depth on the two replicas through
    the kernel, how many characters agree is reported (replaying the
    delivered prefix through prefill rounds differently from decode).
    Both gated on one resume and a balanced tenant.

25. observability — on replicas_1's warmed server: a JSON and an SSE chat
    alone, then 4 JSON + 2 SSE at once, each under a thread_id, in a
    counted window. Gates: each chat's /debug/flight record has the answer's
    and the verify's admissions on replica 0, a tick window whose ticks'
    phase_ms sum to pump_ms (within 0.01 ms) and whose decode tokens are
    the two admissions' (alone; at least that beside others), and parses in
    its Chrome form; /metrics' TTFT count grew by the admissions, TPOT's by
    those with tokens after their first tick, the tick-duration count by
    the pump's ticks, the nine families JAX registers all present; the tick
    events' decode tokens equal the engine's growth, no capture in a tick,
    one paged launch per layer per sub-step (the card's the same). Then
    the server's first /debug/profile?seconds=3 (create_server warmed the
    profiler) while 4 chats of 256 tokens decode: 200, a trace file naming
    the paged kernel's device functions inside the graph replays and
    holding the pump's decode_tick#N ranges (turned on by hand: tracing
    needs OpenTelemetry), a concurrent call 409; reported beside the paged
    wrapper's tally and the pump's ticks over the request, with the trace's
    event categories.
26. escape_hatch_bf16, escape_hatch_f32 — the paged path's fallback to the
    contiguous engine: with the failover budget at 0 the replica's ticks
    fail (the answer and its crash retry) and the provider answers from the
    contiguous engine: on replicas_1's pipeline at full width (bf16, flash
    once per layer for its prefill, no paged launch; the agreeing
    characters and the peak memory reported), and in float32 at 8B width
    cut to 2 layers (plain attention), where the text must equal the
    uninterrupted paged answer.
27. cli — ``python -m sentio_tpu_torch info`` names the card; ``trace`` at
    the default settings answers on the card and writes a Chrome trace with
    tick slices (the tiny presets' head dims are not among the kernels').

``--only-new`` runs the build, the kernel checks and phases 21-27 only
(random Llama-3-8B weights) and ends without the result lines.
``--rounds-only`` runs the build and replicas_1's warmup and rounds only,
to compare two trees' round times in one call (copied into the other
tree's root, it drives that tree's package), and ends the same way.

The last lines are the nvidia-smi line, one {"kernels": [...]} line (each
kernel's ``launches`` from the counted chats, through the wrappers' counts
added per graph replay, and beside them the card's own counts of the same
chats and of the profiled chat), and {"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
MAX_ABS_LIMIT, MEAN_ABS_LIMIT = 2e-2, 2e-3
# kernel vs plain decode attention inside a 32-layer bf16 model: the two
# attention outputs round to bf16 from float32 sums taken in another order,
# and a rare 1-ulp flip propagates through the remaining layers
LOGITS_LIMIT = 0.25
MAX_TOKENS = 48
N_CHUNKS = 2048
SEED = 0


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / BF16_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(torch, fn, iters: int = 20, warmup: int = 3, graph: bool = False) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls between two CUDA
    events; with ``graph`` the calls are captured once in a CUDA graph and
    the replay is timed (device time, without the host's launch cost)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    def run():
        for _ in range(iters):
            fn()

    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            run()
        run = captured.replay
        run()
        torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(out, ref) -> tuple[float, float]:
    diff = (out.float() - ref.float()).abs()
    if not bool(diff.isfinite().all()):
        raise AssertionError("kernel output is not finite where the plain version is")
    return float(diff.max()), float(diff.mean())


def check_limits(name: str, max_err: float, mean_err: float) -> None:
    if max_err > MAX_ABS_LIMIT or mean_err > MEAN_ABS_LIMIT:
        raise AssertionError(f"{name}: max {max_err:.3e} / mean {mean_err:.3e} over "
                             f"limits {MAX_ABS_LIMIT} / {MEAN_ABS_LIMIT}")


# ------------------------------------------------------------ kernel checks


# decode lengths (index of each row's current token) of the serving batch
# in the smoke: ragged, a scratch row at length 0, partial last pages
SERVING_LENS = [0, 5, 127, 128, 1000, 2047, 3000, 8191]
# a /chat's decode: one live slot of ~3,300 tokens (26 pages), the seven
# idle slots at length 0 on the scratch page, as the engine keeps them
CHAT_LENS = [3299, 0, 0, 0, 0, 0, 0, 0]
PAGES_PER_SPAN_SWEEP = (1, 2, 4)
# (B, H, Hkv, D, page, pages a row): Llama-3-8B's decode in the serving
# engine, and the eval's bench LLM (dim 512, 8 / 4 heads) on its engine of
# 16-token pages and 2,048-token windows
SERVING_GEOMETRY = (8, 32, 8, 128, 128, 64)
EVAL_GEOMETRY = (8, 8, 4, 64, 16, 128)
# the eval engine's rows: 1, 17 and 2,048 keys (a whole window) among
# ragged others, every row on pages of its own
EVAL_LENS = [0, 16, 2047, 5, 700, 1023, 1500, 31]


def paged_problem(torch, dev, lens_list=SERVING_LENS, geometry=SERVING_GEOMETRY,
                  scratch_idle: bool = True):
    """A decode shape (``geometry`` as (B, H, Hkv, D, page, NB)) over
    1 + B·NB pages of random bf16 K/V; with ``scratch_idle`` rows at length
    0 sit on scratch page 0, the others (all of them without it) own NB
    shuffled pages. Returns q, the pools, table, lens, the lengths as a
    list, and (page id, first unowned slot) for every owned page past a
    row's length (slot 0) and each current page's tail, the scratch page's
    included."""
    b, h, hkv, d, page, nb = geometry
    num_pages = 1 + b * nb
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    kp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    table = torch.zeros((b, nb), dtype=torch.int32)
    perm = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(SEED)) + 1).tolist()
    idle = [row for row in range(b) if scratch_idle and lens_list[row] == 0]
    unowned = [(0, 1)] if idle else []  # the scratch page past slot 0
    for row in range(b):
        if row in idle:
            continue
        owned = [perm.pop() for _ in range(nb)]
        table[row] = torch.tensor(owned, dtype=torch.int32)
        used, tail = lens_list[row] // page + 1, lens_list[row] % page + 1
        unowned += [(owned[used - 1], tail)] + [(pid, 0) for pid in owned[used:]]
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    return q, kp, vp, table.to(dev), lens, lens_list, unowned


def span_sweep(quant: bool = False) -> dict:
    """A paged kernel's source (bf16, or the int8 one with ``quant``) built
    at each span size of the sweep: the committed build at its size."""
    from sentio_tpu_torch.kernels.paged_attention import (
        KERNEL,
        KERNEL_QUANT,
        PAGES_PER_SPAN,
        PAGES_PER_SPAN_QUANT,
        span_kernel,
    )

    committed, kernel = (PAGES_PER_SPAN_QUANT, KERNEL_QUANT) if quant else (PAGES_PER_SPAN, KERNEL)
    return {pps: kernel if pps == committed else span_kernel(pps, quant)
            for pps in PAGES_PER_SPAN_SWEEP}


def sdpa_decode_ms(torch, q, k, v, lens) -> float:
    """The paged kernels' yardstick: SDPA over each row's window gathered
    densely beforehand (k, v [B, S, Hkv, D] bf16), keys past a row's length
    zeroed and masked."""
    import torch.nn.functional as F

    b, h, d = q.shape
    window, hkv = k.shape[1], k.shape[2]
    valid = torch.arange(window, device=q.device)[None, :] <= lens[:, None].long()

    def dense(x):
        x = torch.where(valid[:, :, None, None], x, 0).transpose(1, 2)
        return x.repeat_interleave(h // hkv, dim=1)

    dense_k, dense_v, mask = dense(k), dense(v), valid[:, None, None, :]
    return time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], dense_k, dense_v, attn_mask=mask), graph=True)


def paged_check(torch, dev, sweep: dict, name: str, lens_list=SERVING_LENS,
                quant: bool = False, geometry=SERVING_GEOMETRY,
                scratch_idle: bool = True) -> dict:
    """A paged kernel at a decode shape of :func:`paged_problem`: the bf16
    kernel with NaN in every owned page past a row's length and in each
    current page's tail, or (``quant``) the int8 kernel over those pools
    quantized with the port's quantize_kv, with random int8 codes and NaN
    f16 scales in the same slots (the kernel must never read them). Held
    against the float32 plain version on the same inputs, and timed at each
    span size of ``sweep`` (:func:`span_sweep`; each build held to the same
    limits) beside the plain version and SDPA."""
    from sentio_tpu_torch.kernels.paged_attention import (
        KERNEL_QUANT,
        PAGES_PER_SPAN,
        PAGES_PER_SPAN_QUANT,
        _launch,
        paged_attention,
        paged_attention_plain,
        paged_attention_quant,
        paged_attention_quant_plain,
        quant_occupancy,
    )
    from sentio_tpu_torch.runtime.paged import dequantize_kv, quantize_kv

    q, kp, vp, table, lens, lens_list, unowned = paged_problem(torch, dev, lens_list, geometry,
                                                               scratch_idle)
    b, h, d = q.shape
    _, page, hkv, _ = kp.shape
    nb = table.shape[1]
    tl = table.long()
    if quant:
        (k_q, k_s), (v_q, v_s) = quantize_kv(kp), quantize_kv(vp)
        del kp, vp
        gen = torch.Generator(device=dev).manual_seed(SEED + 11)
        for pid, tail in unowned:
            for codes, scales in ((k_q, k_s), (v_q, v_s)):
                codes[pid, tail:] = torch.randint(-128, 128, codes[pid, tail:].shape,
                                                  generator=gen, device=dev, dtype=torch.int8)
                scales[pid, tail:] = float("nan")
        pools = (k_q, k_s, v_q, v_s)
        kernel_fn, plain_fn = paged_attention_quant, paged_attention_quant_plain
        dense_k, dense_v = (dequantize_kv(c[tl], sc[tl], torch.bfloat16).reshape(b, -1, hkv, d)
                            for c, sc in ((k_q, k_s), (v_q, v_s)))
        key_bytes, committed = hkv * (d + 2) * 2, PAGES_PER_SPAN_QUANT  # codes + f16 scale
    else:
        for pid, tail in unowned:
            kp[pid, tail:] = float("nan")
            vp[pid, tail:] = float("nan")
        pools = (kp, vp)
        kernel_fn, plain_fn = paged_attention, paged_attention_plain
        dense_k, dense_v = (x[tl].reshape(b, -1, hkv, d) for x in (kp, vp))
        key_bytes, committed = hkv * d * 2 * 2, PAGES_PER_SPAN
    kernel_name = "paged_attention_quant" if quant else "paged_attention"

    out = kernel_fn(q, *pools, table, lens)
    torch.cuda.synchronize()
    ref = plain_fn(q.float(), *pools, table, lens)
    max_err, mean_err = errors(out, ref)
    check_limits(f"{kernel_name} {name}", max_err, mean_err)
    sweep_ms = {}
    for pps, kernel in sweep.items():
        check_limits(f"{kernel_name} {name} pages_per_span={pps}",
                     *errors(_launch(kernel, q, *pools, table, lens), ref))
        sweep_ms[pps] = time_ms(torch, lambda: _launch(kernel, q, *pools, table, lens),
                                graph=True)

    ms = time_ms(torch, lambda: kernel_fn(q, *pools, table, lens), graph=True)
    plain_ms = time_ms(torch, lambda: plain_fn(q, *pools, table, lens), iters=5)
    library_ms = sdpa_decode_ms(torch, q, dense_k, dense_v, lens)
    keys = sum(n + 1 for n in lens_list)  # 14,506 at the serving lengths
    # the owned keys' K and V, q in, out, table, lens; the products in
    # bf16 on the tensor cores (the int8 kernel's too)
    n_bytes = keys * key_bytes + 2 * q.numel() * 2 + table.numel() * 4 + b * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * h * d * keys)
    n_spans = -(-nb // committed)
    live_blocks = hkv * sum(-(-(n // page + 1) // committed) for n in lens_list)
    case = {"case": name, "lens": lens_list, "geometry": dict(zip(
                ("b", "h", "hkv", "d", "page", "pages_per_row"), geometry)), "max_abs_err": max_err,
            "mean_abs_err": mean_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_bytes": n_bytes, "library_ms": library_ms,
            "pages_per_span": committed, "blocks": b * hkv * n_spans,
            "live_blocks": live_blocks, "ms_by_pages_per_span": sweep_ms}
    if quant:
        case["blocks_per_sm"] = quant_occupancy(KERNEL_QUANT, h // hkv, d, page)
    emit("kernel", name=kernel_name, **case)
    return case


def flash_case(torch, dev, name, b, t, h, d, causal, lens_list) -> dict:
    import torch.nn.functional as F

    from sentio_tpu_torch.kernels.flash_attention import flash_attention, flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + t + h)
    q, k, v = (torch.randn((b, t, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    out = flash_attention(q, k, v, lens, causal=causal)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), lens, causal=causal)
    max_err, mean_err = errors(out, ref)
    check_limits(name, max_err, mean_err)
    if not bool((out[lens == 0] == 0).all()):
        raise AssertionError(f"{name}: rows with kv_lens == 0 must be exactly 0")

    ms = time_ms(torch, lambda: flash_attention(q, k, v, lens, causal=causal), graph=True)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, lens, causal=causal),
                       iters=5)
    # yardstick: SDPA with the kernel's mask, or with none (its flash path)
    # where every row attends to all T keys
    mask = None
    if any(n < t for n in lens_list):
        pos = torch.arange(t, device=dev)
        mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
        if causal:
            mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None), graph=True)
    # what this data needs: the attendable (query, key) pairs' operations;
    # q and out in full, K and V rows below each kv_len (the kernel never
    # reads the others), the lengths
    pairs = sum(min(q_pos + 1, n) if causal else n for n in lens_list for q_pos in range(t))
    n_bytes = 2 * q.numel() * 2 + 2 * sum(lens_list) * h * d * 2 + b * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * h * d * pairs)
    case = {"case": name, "max_abs_err": max_err, "mean_abs_err": mean_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library_masked": mask is not None}
    emit("kernel", name="flash_attention", **case)
    return case


def prefill_flash_case(torch, dev, name, b, t, s, h, d, lens_list=None) -> dict:
    """The causal kernel at the contiguous engine's prefill shape: T new
    queries against the whole cache window (S > T keys, kv heads expanded,
    ``kv_lens`` None as the engine passes it, or ragged). The window's tail
    (keys at or past T, unwritten in the engine) is NaN here: the kernel
    must read none of it. Held to the float32 plain version, timed beside
    it and beside SDPA with ``is_causal`` over the first T keys."""
    import torch.nn.functional as F

    from sentio_tpu_torch.kernels import flash_attn_fn
    from sentio_tpu_torch.kernels.flash_attention import flash_attention_plain

    gen = torch.Generator(device=dev).manual_seed(SEED + t + s + h)
    q = torch.randn((b, t, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
    k, v = (torch.randn((b, s, h, d), generator=gen, device=dev, dtype=torch.bfloat16)
            for _ in range(2))
    k[:, t:] = float("nan")
    v[:, t:] = float("nan")
    lens = (torch.tensor(lens_list, dtype=torch.int32, device=dev)
            if lens_list is not None else None)
    out = flash_attn_fn(q, k, v, lens)
    torch.cuda.synchronize()
    ref = flash_attention_plain(q.float(), k.float(), v.float(), lens, causal=True)
    max_err, mean_err = errors(out, ref)
    check_limits(name, max_err, mean_err)
    ms = time_ms(torch, lambda: flash_attn_fn(q, k, v, lens), graph=True)
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, lens, causal=True),
                       iters=3, warmup=1)
    qt, kt, vt = (x[:, :t].transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), graph=True)
    # what this data needs: each row's causal keys below its kv_len (the
    # window's tail is never read), q and out, those K and V rows
    row_lens = [min(n, t) for n in (lens_list or [s] * b)]
    pairs = sum(min(q_pos + 1, n) for n in row_lens for q_pos in range(t))
    n_bytes = 2 * q.numel() * 2 + 2 * sum(row_lens) * h * d * 2 + b * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * h * d * pairs)
    case = {"case": name, "kv_lens": lens_list, "max_abs_err": max_err,
            "mean_abs_err": mean_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_operations": 4 * h * d * pairs,
            "library_ms": library_ms, "library_masked": False}
    emit("kernel", name="flash_attention", **case)
    return case


def flash_checks(torch, dev) -> list[dict]:
    """The embedder's ingest batch (B=128, T=512, H=16, D=64) and the tiny
    cross-encoder's rerank batch (B=32, T=128, H=2, D=32), bidirectional as
    the main path runs them and causal, with ragged and zero lengths; then
    the ingest batch at its real lengths: ~512-byte chunks under the byte
    tokenizer fill every row to 512."""
    rng = torch.Generator().manual_seed(SEED + 1)
    emb_lens = [0, 512, 1, 64] + torch.randint(0, 513, (124,), generator=rng).tolist()
    ce_lens = [0, 128, 3] + torch.randint(0, 129, (29,), generator=rng).tolist()
    cases = []
    for causal in (False, True):
        tag = "causal" if causal else "bidirectional"
        cases.append(flash_case(torch, dev, f"embedder_b128_t512_h16_d64_{tag}",
                                128, 512, 16, 64, causal, emb_lens))
        cases.append(flash_case(torch, dev, f"cross_encoder_b32_t128_h2_d32_{tag}",
                                32, 128, 2, 32, causal, ce_lens))
    cases.append(flash_case(torch, dev, "ingest_full_b128_t512_h16_d64_bidirectional",
                            128, 512, 16, 64, False, [512] * 128))
    # Llama-3-8B's prefill in the contiguous engine: a ~3,300-3,700-token
    # chat prompt pads to 4096 in a window of 8192; then a batch of four at
    # the 1024 bucket (window 2048) with ragged kv_lens, a zero among them
    cases.append(prefill_flash_case(torch, dev, "llama8b_prefill_b1_t4096_s8192_h32_d128_causal",
                                    1, 4096, 8192, 32, 128))
    cases.append(prefill_flash_case(torch, dev, "llama8b_prefill_b4_t1024_s2048_h32_d128_causal",
                                    4, 1024, 2048, 32, 128, [2048, 700, 1, 0]))
    return cases


def sass_counts(kernel) -> dict:
    """Tensor-core instructions in the SASS of a kernel's library:
    ``HGMMA`` (Hopper's warpgroup products) and ``HMMA`` (warp products)."""
    import shutil
    from pathlib import Path

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        raise RuntimeError("cuobjdump not found: the build check reads each library's SASS")
    sass = subprocess.run([tool, "-sass", str(kernel.library)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: len(re.findall(rf"\b{op}\.", sass)) for op in ("HGMMA", "HMMA")}


# -------------------------------------------------------------- the slice


def corpus(n: int):
    """``n`` synthetic chunks of ~512 bytes from a seeded word list."""
    import numpy as np

    from sentio_tpu_torch.models.document import Document

    rng = np.random.default_rng(SEED)
    syllables = ["ka", "lo", "mi", "ne", "ru", "sa", "ti", "vo", "ze", "pa", "qui", "dor"]
    words = sorted({"".join(rng.choice(syllables, size=rng.integers(2, 4)))
                    for _ in range(600)})
    docs = []
    for i in range(n):
        text = ""
        while len(text) < 500:
            text += " ".join(rng.choice(words, size=8)) + ". "
        docs.append(Document(text=text[:512].strip(), id=f"chunk-{i:04d}",
                             metadata={"source": f"corpus/{i // 64:02d}.md"}))
    return docs, words


# each hand-written kernel's device functions by name (no name contains
# another's), with the wrapper that launches them and the function's slot in
# the library's device-side count: a paged entry point launches its split
# kernel (slot 0) and the combine (slot 1)
DEVICE_FUNCTIONS = {"paged_decode_kernel": ("paged_attention", 0),
                    "paged_combine_kernel": ("paged_attention", 1),
                    "paged_decode_int8_kernel": ("paged_attention_quant", 0),
                    "paged_combine_int8_kernel": ("paged_attention_quant", 1),
                    "flash_fwd_kernel": ("flash_attention", 0)}


def wrappers() -> dict:
    """The three kernels' wrappers (their launch counts) by name."""
    from sentio_tpu_torch.kernels import FLASH_KERNEL, PAGED_KERNEL, PAGED_QUANT_KERNEL

    return {"paged_attention": PAGED_KERNEL, "paged_attention_quant": PAGED_QUANT_KERNEL,
            "flash_attention": FLASH_KERNEL}


def card_launches(torch) -> dict:
    """Each device function's launches as the card itself counted them
    (every kernel adds one from its first thread, graph replays included),
    since its library was loaded; waits for the device."""
    torch.cuda.synchronize()
    counts = {name: k.device_launches() for name, k in wrappers().items()}
    return {fn: counts[name][slot] for fn, (name, slot) in DEVICE_FUNCTIONS.items()}


def card_delta(torch, before: dict) -> dict:
    return {fn: n - before[fn] for fn, n in card_launches(torch).items()}


def check_card(phase: str, card: dict, launches: dict) -> None:
    """Every device function ran on the card as often as its wrapper
    counted launches (a paged wrapper's one count stands for its split
    kernel and its combine)."""
    want = {fn: launches[name] for fn, (name, _) in DEVICE_FUNCTIONS.items()}
    if card != want:
        raise AssertionError(f"{phase}: the card's launch counts {card} disagree with the "
                             f"wrappers' {want}")


ENGINE_COUNTERS = ("prefix_hits", "prefix_hit_tokens", "prefill_tokens", "sub_steps",
                   "graph_captures", "graph_replays", "graph_capture_s")


def counter_deltas(before: dict, after: dict) -> dict:
    """How the engine's counters (``engine.stats()``) moved."""
    return {f"{k}_delta": after[k] - before[k] for k in ENGINE_COUNTERS}


def record_admissions(service) -> list:
    """Wrap ``service.generate`` (the provider's one call for each generate
    and each verify) to record every request's prompt, its prefix-hit and
    prefilled tokens, and how the engine's counters moved during it."""
    calls = []
    engine, generate = service.engine, service.generate

    def recorded(prompt, **kwargs):
        before = engine.stats()
        result = generate(prompt, **kwargs)
        service.wait_idle()
        after = engine.stats()
        calls.append({"prompt": prompt, "prompt_tokens": result.prompt_tokens,
                      "prefill_tokens": result.prefill_tokens,
                      "prefix_hit_tokens": result.prefix_hit_tokens,
                      "generated_tokens": len(result.tokens),
                      **counter_deltas(before, after)})
        return result

    service.generate = recorded
    return calls


def shared_weights(pipeline) -> dict:
    """``build_pipeline``'s keyword arguments that reuse ``pipeline``'s
    weight tensors (Llama, embedder, cross-encoder): later phases share
    them, and the pipeline itself can be freed."""
    engine = pipeline.generator.provider.engine
    return dict(llama_config=engine.cfg, llama_params=engine.params,
                embedder_config=pipeline.embedder.model_config,
                embedder_params=pipeline.embedder.params,
                reranker_config=pipeline.reranker.model_config,
                reranker_params=pipeline.reranker.params)


def build_slice(torch, dev, phase: str, settings, shared=None, ingest: bool = True,
                **weights):
    """Build the pipeline (on the weight tensors of ``shared``, a
    :func:`shared_weights` dict, when given, and on ``weights``, such as a
    draft), warm its service up as the entry point does, and ingest the
    corpus (unless not ``ingest``). Returns the pipeline, the documents, the
    corpus words and the warmup's stats."""
    from sentio_tpu_torch.pipeline import build_pipeline

    t0 = time.perf_counter()
    pipeline = build_pipeline(settings, device=dev, seed=SEED, **{**(shared or {}), **weights})
    torch.cuda.synchronize()
    engine = pipeline.generator.provider.engine
    paged = pipeline.service is not None
    emit(f"{phase}_build", seconds=time.perf_counter() - t0,
         llama=(engine.cfg if paged else engine.model_config).__dict__,
         embedder=pipeline.embedder.model_config.__dict__,
         cross_encoder=pipeline.reranker.model_config.__dict__,
         retrieval=settings.retrieval.strategy, fusion=settings.retrieval.fusion_method,
         bm25_backend=type(pipeline.bm25_index).__name__ if pipeline.bm25_index else None,
         engine=type(engine).__name__, kv_quant=engine.kv_quant if paged else None,
         pool_bytes=engine.pool.hbm_bytes if paged else 0,
         draft=pipeline.speculative_info,
         memory_allocated=torch.cuda.memory_allocated())
    warm = None
    if paged:
        warm = pipeline.warmup()
        torch.cuda.synchronize()
        emit(f"{phase}_warmup", **warm, graphs_frozen=engine.graphs_frozen)
        if (warm["graph_captures"] != len(engine.graph_variants) or not engine.graphs_frozen
                or min(warm["head_tokens"]) <= 0):
            raise AssertionError(f"{phase}: warmup must capture every graph variant "
                                 f"({len(engine.graph_variants)}) and leave the template "
                                 f"head warm: {warm}")

    docs, words = corpus(N_CHUNKS)
    if ingest:
        t0 = time.perf_counter()
        pipeline.ingest(docs)
        torch.cuda.synchronize()
        emit(f"{phase}_ingest", chunks=len(docs), seconds=time.perf_counter() - t0,
             index_size=pipeline.index.size)
    return pipeline, docs, words, warm


def chat_window(torch, pipeline, questions) -> dict:
    """Answer ``questions`` one after another with every launch count set to
    0 just before and read just after: the chats with their seconds, the
    wrappers' counts and the card's."""
    counters = wrappers()
    card0 = card_launches(torch)
    for kernel in counters.values():
        kernel.launches = 0
    chats = []
    t_all = time.perf_counter()
    for question in questions:
        t0 = time.perf_counter()
        response = pipeline.chat(question)
        torch.cuda.synchronize()
        chats.append((response, time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    launches = {name: kernel.launches for name, kernel in counters.items()}
    return {"chats": chats, "seconds": total_s, "launches": launches,
            "card": card_delta(torch, card0)}


def check_answered(phase: str, i: int, response: dict) -> None:
    """A chat answered with nothing degraded: an answer, no retrieval or
    generation error, no rerank fallback, a verification that ran."""
    meta = response["metadata"]
    if not response["answer"]:
        raise AssertionError(f"{phase} chat {i} returned an empty answer: {meta}")
    degraded = {k: meta[k] for k in ("retrieval_error", "generation_error") if k in meta}
    if degraded or meta.get("rerank_fallback"):
        raise AssertionError(f"{phase} chat {i} degraded: {degraded}, rerank_fallback "
                             f"{meta.get('rerank_fallback')}")
    notes = response["verification"].get("notes", [])
    if any(str(n).startswith("verifier error") for n in notes):
        raise AssertionError(f"{phase} chat {i}: verification failed: {notes}")


def slice_questions(docs, words) -> list:
    return [docs[17].text, f"What does the corpus say about {words[3]} and {words[40]}?",
            f"Summarize the passages that mention {words[100]}."]


def run_slice(torch, dev, phase: str, settings, shared=None) -> dict:
    """The paged slice: build, warm up, ingest, then 3 chats in a counted
    window (:func:`chat_window`), each chat's generate and verify
    admissions recorded (:func:`record_admissions`)."""
    pipeline, docs, words, warm = build_slice(torch, dev, phase, settings, shared)
    engine = pipeline.generator.provider.engine
    questions = slice_questions(docs, words)
    calls = record_admissions(pipeline.service)
    pipeline.service.wait_idle()
    stats0 = engine.stats()
    sub_steps0 = engine.total_sub_steps
    try:
        window = chat_window(torch, pipeline, questions)
    finally:
        del pipeline.service.generate  # the recording wrapper
    chats, launches, card = window["chats"], window["launches"], window["card"]
    sub_steps = engine.total_sub_steps - sub_steps0
    stats = engine.stats()

    if len(calls) != 2 * len(chats):
        raise AssertionError(f"{phase}: expected a generate and a verify per chat, got "
                             f"{len(calls)} engine calls")
    for i, (response, seconds) in enumerate(chats):
        meta = response["metadata"]
        generate, verify = ({k: v for k, v in c.items() if k != "prompt"}
                            for c in calls[2 * i : 2 * i + 2])
        emit(f"{phase}_chat", index=i, seconds=seconds, stage_ms=meta["stage_ms"],
             generated_tokens=meta["generated_tokens"], answer_chars=len(response["answer"]),
             verdict=response["verification"].get("verdict"),
             sources=[s["id"] for s in response["sources"]], generate=generate, verify=verify)
        if verify["prefix_hit_tokens_delta"] <= 0:
            raise AssertionError(f"{phase} chat {i}: the verify admission missed the radix "
                                 f"tree: {verify}")
        check_answered(phase, i, response)
    if chats[0][0]["metadata"]["retrieved_ids"][0] != docs[17].id:
        raise AssertionError(f"{phase}: a chunk's own text did not retrieve that chunk first")
    if calls[0]["prefix_hit_tokens"] <= 0:
        raise AssertionError(f"{phase}: chat 1's generate missed the warmed template head: "
                             f"{calls[0]}")
    n_layers = engine.cfg.n_layers
    emit(phase, chats=len(chats), seconds=window["seconds"], decode_sub_steps=sub_steps,
         launches=launches, device_launches=card, expected_decode_launches=n_layers * sub_steps,
         pipeline_depth=engine.pipeline_depth, prefix_cache=engine._radix is not None,
         **{k: stats[k] - stats0[k] for k in ENGINE_COUNTERS},
         prefix_cache_pages=stats["prefix_cache_pages"],
         peak_memory=torch.cuda.max_memory_allocated())
    if stats["graph_replays"] - stats0["graph_replays"] <= 0:
        raise AssertionError(f"{phase}: no decode sub-step was a graph replay")
    if stats["graph_captures"] != stats0["graph_captures"]:
        raise AssertionError(f"{phase}: a graph was captured after warmup")
    if launches["flash_attention"] <= 0:
        raise AssertionError(f"{phase}: the flash kernel never launched: {launches}")
    decode = "paged_attention_quant" if engine.pool.quantized else "paged_attention"
    other = "paged_attention" if engine.pool.quantized else "paged_attention_quant"
    if launches[decode] != n_layers * sub_steps or sub_steps <= 0:
        raise AssertionError(f"{phase}: a decode sub-step bypassed {decode}: {launches}")
    if launches[other] != 0:
        raise AssertionError(f"{phase}: {other} ran on a {engine.kv_quant!r} pool: {launches}")
    check_card(phase, card, launches)
    return {"pipeline": pipeline, "launches": launches, "device_launches": card,
            "questions": questions, "warmup": warm, "words": words,
            "chats": [response for response, _ in chats], "generate_prompt": calls[0]["prompt"]}


def run_contig_slice(torch, dev, settings, shared) -> dict:
    """USE_PAGED_KV=0 at full width on the shared weights, default hybrid
    retrieval: 3 chats on the contiguous engine, each prefill through the
    causal flash kernel at D 128. Gates: every engine call's flash launches
    are one per layer per prefill, the paged kernels never ran, and the
    wrappers' counts equal the card's."""
    phase = "slice_contig"
    pipeline, docs, words, _ = build_slice(torch, dev, phase, settings, shared)
    engine = pipeline.generator.provider.engine
    flash = wrappers()["flash_attention"]
    calls, generate = [], engine.generate

    def recorded(prompts, **kwargs):
        torch.cuda.synchronize()
        f0, p0, d0, t0 = flash.launches, engine.prefills, engine.decode_steps, time.perf_counter()
        results = generate(prompts, **kwargs)
        torch.cuda.synchronize()
        calls.append({"prompt": prompts[0], "prompt_tokens": [r.prompt_tokens for r in results],
                      "tokens": [len(r.tokens) for r in results],
                      "finish_reason": [r.finish_reason for r in results],
                      "prefills": engine.prefills - p0, "decode_steps": engine.decode_steps - d0,
                      "flash_launches": flash.launches - f0,
                      "seconds": time.perf_counter() - t0})
        return results

    engine.generate = recorded
    try:
        window = chat_window(torch, pipeline, slice_questions(docs, words))
    finally:
        engine.generate = generate
    chats, launches, card = window["chats"], window["launches"], window["card"]
    n_layers = engine.model_config.n_layers
    for i, (response, seconds) in enumerate(chats):
        meta = response["metadata"]
        emit(f"{phase}_chat", index=i, seconds=seconds, stage_ms=meta["stage_ms"],
             generated_tokens=meta["generated_tokens"], answer_chars=len(response["answer"]),
             verdict=response["verification"].get("verdict"),
             calls=[{k: v for k, v in c.items() if k != "prompt"}
                    for c in calls[2 * i : 2 * i + 2]])
        check_answered(phase, i, response)
    prefills = sum(c["prefills"] for c in calls)
    llm_flash = sum(c["flash_launches"] for c in calls)
    emit(phase, chats=len(chats), seconds=window["seconds"], engine_calls=len(calls),
         prefills=prefills, llm_flash_launches=llm_flash, launches=launches,
         device_launches=card, peak_memory=torch.cuda.max_memory_allocated())
    if len(calls) != 2 * len(chats) or any(c["prefills"] != 1 for c in calls):
        raise AssertionError(f"{phase}: expected one prefill per generate and verify: {calls}")
    if any(c["flash_launches"] != n_layers * c["prefills"] for c in calls):
        raise AssertionError(f"{phase}: a prefill layer bypassed the flash kernel: {calls}")
    if launches["paged_attention"] or launches["paged_attention_quant"]:
        raise AssertionError(f"{phase}: a paged kernel ran on the contiguous engine: "
                             f"{launches}")
    check_card(phase, card, launches)
    return {"pipeline": pipeline, "launches": launches, "device_launches": card,
            "llm_flash_launches": llm_flash, "prefills": prefills,
            "generate_prompt": calls[0]["prompt"]}


def contig_logits_check(torch, pipeline, prompt: str) -> dict:
    """The contiguous engine's prefill of ``prompt`` through the flash
    kernel and through plain attention, then 4 teacher-forced decode steps
    (plain attention over each run's own cache; the forced tokens are the
    kernel run's greedy picks): the last prompt logit and the 4 steps held
    to LOGITS_LIMIT. Also times one eager decode step (16 in a row, CUDA
    events) and, under the profiler, its device busy time."""
    from torch.profiler import ProfilerActivity, profile

    from sentio_tpu_torch.kernels import flash_attn_fn
    from sentio_tpu_torch.models.llama import llama_forward

    engine = pipeline.generator.provider.engine
    cfg = engine.model_config
    runs, forced = [], []
    for attn_fn in (flash_attn_fn, None):
        engine.attn_fn = attn_fn
        ids, pos, lens, cache, _n, window, mask = engine._encode_batch([prompt], MAX_TOKENS)
        with torch.inference_mode():
            logits = engine._prefill(ids, pos, cache, mask)
            steps = [logits[0, int(lens[0]) - 1]]
            del logits
            at = torch.tensor(lens[:1].astype("int64"), device=cache["k"].device)
            for s in range(4):
                if len(forced) <= s:
                    forced.append(int(steps[-1].argmax()))
                tok = torch.tensor([[forced[s]]], device=at.device)
                out, _ = llama_forward(engine.params, cfg, tok, positions=at[:, None],
                                       cache=cache, cache_index=at)
                steps.append(out[0, -1])
                at = at + 1
        runs.append(torch.stack(steps))
        if attn_fn is not None:
            def step():
                engine._decode_step(torch.tensor(forced[:1], device=at.device), at, cache,
                                    0.0, 0)

            decode_ms = time_ms(torch, step, iters=16, warmup=2)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(4):
                    step()
                torch.cuda.synchronize()
            decode_busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                                 if e.self_device_time_total > 0) / 4e3
        del cache
    engine.attn_fn = flash_attn_fn
    diff = (runs[0] - runs[1]).abs().amax(dim=-1).tolist()
    result = {"prompt_tokens": int(lens[0]), "prefill_width": int(ids.shape[1]),
              "window": window, "max_abs_diff_per_step": diff,
              "logit_std": float(runs[1].std()), "decode_step_ms": decode_ms,
              "decode_step_device_busy_ms": decode_busy_ms,
              "greedy_agree": [int(a) == int(b) for a, b in
                               zip(runs[0].argmax(-1).tolist(), runs[1].argmax(-1).tolist())]}
    emit("logits_contig", **result)
    if not bool(torch.isfinite(runs[0]).all()) or max(diff) > LOGITS_LIMIT:
        raise AssertionError(f"logits_contig: kernel vs plain logits differ by {max(diff)} > "
                             f"{LOGITS_LIMIT}")
    return result


def check_int8_slice(sl: dict) -> dict:
    """The int8 slice's own checks: the pool's bytes are L·P·page·Hkv·(D+2)·2
    (int8 codes plus f16 scales, K and V), and the BM25 leg's hits reach
    every fused list."""
    pipeline = sl["pipeline"]
    engine = pipeline.generator.provider.engine
    cfg, pool = engine.cfg, engine.pool
    expected = (cfg.n_layers * pool.k.q.shape[1] * pool.page_size * cfg.n_kv_heads
                * (cfg.head_dim + 2) * 2)
    dense_leg, sparse_leg = pipeline.retriever.retrievers
    pool_k = max(2 * pipeline.settings.retrieval.top_k, 10)
    overlaps = []
    for question, response in zip(sl["questions"], sl["chats"]):
        sparse_ids = [d.id for d in sparse_leg.retrieve(question, pool_k)]
        fused = response["metadata"]["retrieved_ids"]
        overlaps.append({"sparse_hits": len(sparse_ids),
                         "fused_from_sparse": len(set(sparse_ids) & set(fused))})
    result = {"pool_bytes": pool.hbm_bytes, "expected_pool_bytes": expected,
              "legs": [dense_leg.name, sparse_leg.name],
              "bm25_backend": type(pipeline.bm25_index).__name__, "per_chat": overlaps}
    emit("slice_int8_checks", **result)
    if pool.hbm_bytes != expected:
        raise AssertionError(f"int8 pool holds {pool.hbm_bytes} bytes, expected {expected}")
    if not all(o["fused_from_sparse"] > 0 for o in overlaps):
        raise AssertionError(f"the BM25 leg reached no fused list: {overlaps}")
    return result


def logits_check(torch, dev, pipeline, question: str, phase: str = "logits",
                 forced: list | None = None) -> dict:
    """Prefill + 4 teacher-forced decode steps of the generate prompt through
    the kernel path and the plain path; the forced tokens are the kernel
    path's greedy picks (or ``forced``), fed to both. Returns the result
    with the kernel path's logits and the forced tokens."""
    import numpy as np

    from sentio_tpu_torch.kernels import paged_attn_impl
    from sentio_tpu_torch.runtime.paged import _paged_attn_xla

    engine = pipeline.generator.provider.engine
    pipeline.service.wait_idle()  # the engine is driven directly below
    docs = pipeline.index.documents()[:5]
    prompt = pipeline.generator.build_prompt(question, docs)
    window = engine.max_pages_per_seq * engine.page_size
    ids = engine.tokenizer.encode(prompt, add_bos=True)[: window - 8]
    width = engine._prefill_width(len(ids))
    n_pages = width // engine.page_size
    if n_pages > engine.allocator.free_pages and engine._radix is not None:
        # warmup and the chats left cached prefixes in the pool
        engine._radix.evict(n_pages - engine.allocator.free_pages)
    pages = engine.allocator.alloc(n_pages)
    row = torch.zeros((1, engine.max_pages_per_seq), dtype=torch.int32)
    row[0, :n_pages] = torch.tensor(pages, dtype=torch.int32)
    table = row.to(dev)
    id_arr = np.full((1, width), engine.tokenizer.pad_id, np.int64)
    id_arr[0, : len(ids)] = ids
    runs, forced = [], list(forced or [])
    try:
        for impl in (paged_attn_impl, _paged_attn_xla):
            engine.attn_impl = impl
            with torch.inference_mode():
                steps = [engine.prefill_forward(id_arr, np.asarray([len(ids)]),
                                                row.numpy().astype(np.int64)[:, :n_pages])]
                for s in range(4):
                    if len(forced) <= s:
                        forced.append(int(steps[-1].argmax(-1)[0]))
                    tok = torch.tensor([forced[s]], device=dev)
                    lens = torch.tensor([len(ids) + s], dtype=torch.int32, device=dev)
                    steps.append(engine.decode_forward(tok, lens, table))
            runs.append(torch.stack([x[0] for x in steps]))
    finally:
        engine.attn_impl = paged_attn_impl
        engine.allocator.free(pages)
    diff = (runs[0] - runs[1]).abs().amax(dim=-1).tolist()
    result = {"prompt_tokens": len(ids), "max_abs_diff_per_step": diff,
              "logit_std": float(runs[1].std()),
              "greedy_agree": [int(a) == int(b) for a, b in
                               zip(runs[0].argmax(-1).tolist(), runs[1].argmax(-1).tolist())]}
    emit(phase, **result)
    if not bool(torch.isfinite(runs[0]).all()) or max(diff) > LOGITS_LIMIT:
        raise AssertionError(f"{phase}: kernel vs plain logits differ by {max(diff)} > "
                             f"{LOGITS_LIMIT}")
    return {**result, "kernel_logits": runs[0], "forced": forced}


def quantization_error(torch, bf16: dict, int8: dict) -> dict:
    """The int8 engine's kernel-path logits against the bf16 engine's on the
    same prompt and forced tokens: quantization's own error, which the JAX
    package accepts; reported, not gated."""
    diff = (bf16["kernel_logits"] - int8["kernel_logits"]).abs().amax(dim=-1).tolist()
    agree = (bf16["kernel_logits"].argmax(-1) == int8["kernel_logits"].argmax(-1)).tolist()
    result = {"max_abs_diff_per_step": diff, "greedy_agree": agree}
    emit("int8_vs_bf16_logits", **result)
    return result


def graph_check(torch, pipeline, prompt: str, phase: str = "graph") -> dict:
    """``prompt`` decoded greedily twice on the slice's engine: from graph
    replays, then with the same sub-step run eagerly. The prompt's full
    pages are warmed into the radix tree first, so both runs admit the same
    suffix over the same cached pages and run the same sub-steps; their
    tokens must be equal."""
    engine = pipeline.generator.provider.engine
    pipeline.service.wait_idle()  # the engine is driven directly below
    warmed = engine.warm_prefix(prompt)
    runs, tokens = [], []
    try:
        for graphs in (True, False):
            engine.cuda_graphs = graphs
            before = engine.stats()
            t0 = time.perf_counter()
            (result,) = engine.run_all([prompt], max_new_tokens=MAX_TOKENS, temperature=0.0)
            torch.cuda.synchronize()
            after = engine.stats()
            tokens.append(result.tokens)
            runs.append({"graphs": graphs, "seconds": time.perf_counter() - t0,
                         "tokens": len(result.tokens), "prompt_tokens": result.prompt_tokens,
                         "prefix_hit_tokens": result.prefix_hit_tokens,
                         **counter_deltas(before, after)})
    finally:
        engine.cuda_graphs = True
    differ = [i for i, (a, b) in enumerate(zip(*tokens)) if a != b]
    result = {"warmed_tokens": warmed, "runs": runs, "tokens_equal": tokens[0] == tokens[1],
              "first_difference": differ[0] if differ else None}
    emit(phase, **result)
    if tokens[0] != tokens[1] or runs[0]["prefix_hit_tokens"] != runs[1]["prefix_hit_tokens"]:
        raise AssertionError(f"{phase}: graph and eager decoding differ: {result}")
    if runs[0]["graph_replays_delta"] <= 0 or runs[1]["graph_replays_delta"] != 0:
        raise AssertionError(f"{phase}: the graph run must replay and the eager one not: {runs}")
    return result


def chunked_check(torch, dev, prompt: str, chunk: int = 512) -> dict:
    """``prompt`` admitted whole and with ``prefill_chunk=chunk``, greedy:
    the same tokens and the same prefilled token count. Float32 at
    Llama-3-8B width cut to 2 layers (random weights from the seed), one
    slot, plain decode attention: see the module docstring."""
    import dataclasses

    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(SEED + 5), dev)
    runs, tokens = [], []
    for prefill_chunk in (None, chunk):
        engine = ContinuousBatchingEngine(model_config=cfg, params=params, max_slots=1,
                                          page_size=128, max_pages_per_seq=64,
                                          steps_per_tick=16, max_tick_steps=64,
                                          pipeline_depth=2, prefill_chunk=prefill_chunk,
                                          device=dev)
        engine.attn_impl = _paged_attn_xla
        t0 = time.perf_counter()
        (result,) = engine.run_all([prompt], max_new_tokens=MAX_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        tokens.append(result.tokens)
        runs.append({"prefill_chunk": prefill_chunk, "seconds": time.perf_counter() - t0,
                     "prompt_tokens": result.prompt_tokens, "tokens": len(result.tokens),
                     "prefill_tokens": engine.prefill_tokens_total,
                     "segments": -(-result.prompt_tokens // chunk) if prefill_chunk else 1,
                     "graph_replays": engine.graph_replays})
        del engine
    del params
    torch.cuda.empty_cache()
    differ = [i for i, (a, b) in enumerate(zip(*tokens)) if a != b]
    result = {"model": {"dim": cfg.dim, "n_layers": cfg.n_layers, "dtype": cfg.dtype},
              "runs": runs, "tokens_equal": tokens[0] == tokens[1],
              "first_difference": differ[0] if differ else None}
    emit("chunked", **result)
    if tokens[0] != tokens[1] or runs[0]["prefill_tokens"] != runs[1]["prefill_tokens"]:
        raise AssertionError(f"chunked: chunked and whole-prompt admission differ: {result}")
    if runs[1]["segments"] < 2:
        raise AssertionError(f"chunked: the prompt took one segment: {runs}")
    return result


def contig_vs_paged_check(torch, dev, prompt: str) -> dict:
    """``prompt`` decoded greedily by the contiguous engine and by the paged
    engine: the same tokens. Float32 at Llama-3-8B width cut to 2 layers,
    plain attention on both (the kernels take bf16): see the module
    docstring's ``chunked``."""
    import dataclasses

    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(SEED + 6), dev)
    contig = GeneratorEngine(config=GeneratorConfig(max_new_tokens=MAX_TOKENS, dtype="float32"),
                             model_config=cfg, params=params, device=dev)
    contig.attn_fn = None
    t0 = time.perf_counter()
    (ref,) = contig.generate([prompt], max_new_tokens=MAX_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    contig_s = time.perf_counter() - t0
    paged = ContinuousBatchingEngine(model_config=cfg, params=params, max_slots=1,
                                     page_size=128, max_pages_per_seq=64, steps_per_tick=16,
                                     max_tick_steps=64, pipeline_depth=2, device=dev)
    paged.attn_impl = _paged_attn_xla
    t0 = time.perf_counter()
    (got,) = paged.run_all([prompt], max_new_tokens=MAX_TOKENS, temperature=0.0)
    torch.cuda.synchronize()
    paged_s = time.perf_counter() - t0
    del contig, paged, params
    torch.cuda.empty_cache()
    differ = [i for i, (a, b) in enumerate(zip(ref.tokens, got.tokens)) if a != b]
    result = {"model": {"dim": cfg.dim, "n_layers": cfg.n_layers, "dtype": cfg.dtype},
              "prompt_tokens": [ref.prompt_tokens, got.prompt_tokens],
              "tokens": [len(ref.tokens), len(got.tokens)],
              "finish_reason": [ref.finish_reason, got.finish_reason],
              "seconds": {"contiguous": contig_s, "paged": paged_s},
              "tokens_equal": ref.tokens == got.tokens,
              "first_difference": differ[0] if differ else None}
    emit("contig_vs_paged", **result)
    if ref.tokens != got.tokens or ref.prompt_tokens != got.prompt_tokens:
        raise AssertionError(f"contig_vs_paged: the engines' greedy tokens differ: {result}")
    return result


SERVICE_CHATS = 8


def service_check(torch, pipeline, words, phase: str = "service",
                  n_chats: int = SERVICE_CHATS) -> dict:
    """``n_chats`` chats from as many threads at once through the warmed
    service: every chat answered, no graph captured, some tick shared by
    more than one live row, the pool's paged kernel once per layer per
    replayed sub-step (with a draft: no paged kernel at all, every tick a
    spec tick), every count equal to the card's. Reports chat latencies
    (p50, p95)."""
    import threading

    service, engine = pipeline.service, pipeline.generator.provider.engine
    counters = wrappers()
    service.wait_idle()
    before, svc0 = engine.stats(), service.stats()
    card0 = card_launches(torch)
    for kernel in counters.values():
        kernel.launches = 0
    questions = [f"What links {words[5 * i + 1]} to {words[5 * i + 2]}?"
                 for i in range(n_chats)]
    out: list = [None] * n_chats
    start = threading.Barrier(n_chats)

    def chat(i: int) -> None:
        start.wait(timeout=60)
        t0 = time.perf_counter()
        try:
            out[i] = (pipeline.chat(questions[i]), time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            out[i] = exc

    threads = [threading.Thread(target=chat, args=(i,), name=f"smoke-chat-{i}", daemon=True)
               for i in range(n_chats)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall_s = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{phase}: a chat did not return within 600 s")
    service.wait_idle()
    launches = {name: kernel.launches for name, kernel in counters.items()}
    card = card_delta(torch, card0)
    after, svc1 = engine.stats(), service.stats()
    for i, item in enumerate(out):
        if isinstance(item, Exception):
            raise AssertionError(f"{phase} chat {i} raised: {item!r}") from item
        check_answered(phase, i, item[0])
    seconds = sorted(sec for _r, sec in out)
    phase_s = {k: svc1["phase_seconds"][k] - svc0["phase_seconds"][k]
               for k in svc1["phase_seconds"]}
    sub_steps = after["sub_steps"] - before["sub_steps"]
    decode = "paged_attention_quant" if engine.pool.quantized else "paged_attention"
    other = "paged_attention" if engine.pool.quantized else "paged_attention_quant"
    result = {"chats": n_chats, "wall_s": wall_s, "chat_s": seconds,
              "p50_s": seconds[len(seconds) // 2],
              "p95_s": seconds[min(int(len(seconds) * 0.95), len(seconds) - 1)],
              "ticks": svc1["ticks"] - svc0["ticks"],
              "shared_ticks": svc1["shared_ticks"] - svc0["shared_ticks"],
              "max_active_slots": svc1["max_active_slots"], "decode_sub_steps": sub_steps,
              "graph_captures_delta": after["graph_captures"] - before["graph_captures"],
              "completed": svc1["completed"] - svc0["completed"], "shed": svc1["shed"],
              "pump_phase_s": phase_s,
              "stage_ms": [item[0]["metadata"]["stage_ms"] for item in out],
              "launches": launches, "device_launches": card}
    spec = engine.draft_params is not None
    if spec:
        result["spec"] = {"verifies": after.get("spec_verifies", 0)
                          - before.get("spec_verifies", 0),
                          "emitted": after.get("spec_emitted", 0) - before.get("spec_emitted", 0)}
    emit(phase, **result)
    if result["graph_captures_delta"] or result["shared_ticks"] <= 0:
        raise AssertionError(f"{phase}: a capture under traffic, or no tick shared: {result}")
    if result["completed"] != 2 * n_chats:
        raise AssertionError(f"{phase}: expected a generate and a verify per chat: {result}")
    if launches[decode] != (0 if spec else engine.cfg.n_layers * sub_steps) or launches[other]:
        raise AssertionError(f"{phase}: decode launches are not one per layer per sub-step "
                             f"(none under a draft): {result}")
    check_card(phase, card, launches)
    return result


# ------------------------------------------------------------ the HTTP server

HTTP_TIMEOUT_S = 300.0
HTTP_CONCURRENT = 8  # 4 JSON + 4 SSE, released together
# the stream whose client leaves asks for this many tokens: still decoding
# when the server sees it gone, some ticks of up to 64 sub-steps later
DISCONNECT_TOKENS = 2048
_PROM_LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{(.*)\})? (\S+)$')
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Prometheus text format 0.0.4 → {(name, ((label, value), ...)): value};
    raises on a line that does not parse."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE.match(line)
        if m is None:
            raise AssertionError(f"/metrics: unparseable line {line!r}")
        labels = tuple(_PROM_LABEL.findall(m.group(3) or ""))
        samples[(m.group(1), labels)] = float(m.group(4))
    return samples


class HttpClient:
    """http.client against the smoke's server; every read has a timeout."""

    def __init__(self, port: int) -> None:
        self.port = port

    def request(self, method: str, path: str, body=None, headers=None):
        import http.client

        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=HTTP_TIMEOUT_S)
        headers = dict(headers or {})
        if isinstance(body, dict):
            body = json.dumps(body).encode()
            headers["Content-Type"] = "application/json"
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, dict(resp.getheaders()), resp.read()
        finally:
            conn.close()

    def json(self, method: str, path: str, body=None, headers=None):
        status, hdrs, data = self.request(method, path, body, headers)
        return status, hdrs, json.loads(data) if data else None

    def sse(self, payload: dict, close_after_first_token: bool = False,
            after_done: bool = False, headers=None) -> dict:
        """One streamed /chat: the events in order, the seconds to the
        first ``token`` event and to the end. With ``after_done`` the
        stream is read past ``[DONE]`` (a trailing ``verify`` event) to the
        chunked body's end, and the seconds to ``[DONE]`` are kept."""
        import http.client

        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=HTTP_TIMEOUT_S)
        conn.request("POST", "/chat", body=json.dumps({**payload, "stream": True}),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        events, first_token_s, done_s = [], None, None
        try:
            while resp.status == 200:
                line = resp.fp.readline()
                if not line:
                    break
                line = line.decode().strip()
                if line == "0":
                    break  # the chunked body's last chunk
                if not line.startswith("data: "):
                    continue  # chunk sizes, keepalives, blank lines
                raw = line[len("data: "):]
                event = raw if raw == "[DONE]" else json.loads(raw)
                events.append(event)
                if isinstance(event, dict) and "token" in event and first_token_s is None:
                    first_token_s = time.perf_counter() - t0
                    if close_after_first_token:
                        conn.sock.shutdown(2)
                        break
                if event == "[DONE]":
                    done_s = time.perf_counter() - t0
                    if not after_done:
                        break
        finally:
            conn.close()
        return {"status": resp.status, "events": events, "first_token_s": first_token_s,
                "done_s": done_s, "seconds": time.perf_counter() - t0}


def docx_bytes(paragraphs) -> bytes:
    """A minimal .docx: word/document.xml with one run per paragraph."""
    import io
    import zipfile
    from xml.sax.saxutils import escape

    body = "".join(f"<w:p><w:r><w:t>{escape(p)}</w:t></w:r></w:p>" for p in paragraphs)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        zf.writestr("[Content_Types].xml", "<Types/>")
        zf.writestr("word/document.xml", f"<w:document><w:body>{body}</w:body></w:document>")
    return buf.getvalue()


def upload_body(files) -> tuple[bytes, dict]:
    boundary = "sentio-smoke-boundary"
    body = b""
    for name, data in files:
        body += (f'--{boundary}\r\nContent-Disposition: form-data; name="file"; '
                 f'filename="{name}"\r\nContent-Type: application/octet-stream\r\n\r\n'
                 ).encode() + data + b"\r\n"
    return body + f"--{boundary}--\r\n".encode(), {
        "Content-Type": f"multipart/form-data; boundary={boundary}"}


def expected_chunks(settings, files) -> int:
    """Chunks the port's readers and TextChunker make of ``files`` on the
    host, empty ones dropped, as the ingestor stores them."""
    import tempfile
    from pathlib import Path

    from sentio_tpu_torch.ops.chunking import TextChunker
    from sentio_tpu_torch.ops.ingest import DocumentIngestor

    reader = DocumentIngestor(embedder=object(), dense_index=object(), settings=settings)
    chunker = TextChunker(settings.chunking)
    n = 0
    with tempfile.TemporaryDirectory(prefix="smoke-chunks-") as tmp:
        for name, data in files:
            path = Path(tmp) / name
            path.write_bytes(data)
            n += sum(1 for c in chunker.split(reader.load_file(path)) if c.text.strip())
    return n


def check_http_chat(phase: str, i: int, status: int, body: dict) -> None:
    """A /chat answered with a 200 and nothing degraded, as
    ``check_answered`` holds a slice's chats: sources cited, no retrieval
    or generation error, no rerank fallback, a verification that ran."""
    meta = (body or {}).get("metadata", {})
    bad = {k: meta[k] for k in ("retrieval_error", "generation_error", "rerank_fallback")
           if meta.get(k)}
    if status != 200 or meta.get("degraded") is not False or bad or not body.get("sources") \
            or not body.get("answer"):
        raise AssertionError(f"{phase} chat {i}: status {status}, degraded "
                             f"{meta.get('degraded')}, {bad}, {len(body.get('sources', []))} "
                             f"sources, answer {body.get('answer')!r:.80}")
    check_verdict(phase, i, meta.get("evaluation"))


def check_verdict(phase: str, i: int, evaluation) -> None:
    notes = (evaluation or {}).get("notes", [])
    if not evaluation or any(str(n).startswith("verifier error") for n in notes):
        raise AssertionError(f"{phase} chat {i}: verification failed: {evaluation}")


def check_sse_chat(phase: str, i: int, result: dict) -> str:
    """sources → ≥1 token → verdict → [DONE] (so no ``rerank_fallback``
    event), a verification that ran; returns the joined tokens."""
    events = result["events"]
    kinds = [e if e == "[DONE]" else next(iter(e)) for e in events]
    tokens = "".join(e["token"] for e in events if isinstance(e, dict) and "token" in e)
    ok = (result["status"] == 200 and kinds[:1] == ["sources"] and kinds[-2:] == ["verdict",
          "[DONE]"] and set(kinds[1:-2]) == {"token"} and tokens and events[0]["sources"])
    if not ok:
        raise AssertionError(f"{phase} SSE chat {i}: status {result['status']}, events {kinds}")
    check_verdict(phase, i, events[-2]["verdict"])
    return tokens


def serve_http_check(torch, dev, shared) -> dict:
    """The path ``python -m sentio_tpu_torch serve`` takes, minus weight
    loading: a pipeline under ``Settings()`` (the JAX defaults: hybrid rrf,
    bf16 pool, prefix cache, depth 2, the embedding cache and the query
    coalescer on; answers and verdicts capped at MAX_TOKENS) on ``shared``'s
    weights, warmed up, served by ``create_server`` on 127.0.0.1 from a
    thread. Ingest only over HTTP (one multipart /upload of the corpus as
    4 .txt files, an .html and a .docx, then one /embed), 3 JSON chats,
    then 4 JSON and 4 SSE chats at once, every launch count set to 0 just
    before the chats and read just after; then the error paths, /metrics,
    /clear and the shutdown."""
    import gc
    import tempfile
    import threading

    from sentio_tpu_torch.config import GeneratorConfig, Settings
    from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
    from sentio_tpu_torch.serve.app import create_server

    phase = "serve_http"
    settings = Settings(generator=GeneratorConfig(max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS))
    pipeline, docs, words, _warm = build_slice(torch, dev, phase, settings, shared,
                                               ingest=False)
    engine, service = pipeline.generator.provider.engine, pipeline.service
    fallback_dir = tempfile.mkdtemp(prefix="smoke-fallback-")
    server = create_server(settings, pipeline, host="127.0.0.1", port=0,
                           fallback=(FallbackResponseCache(fallback_dir), LLMFallback()))
    thread = threading.Thread(target=server.serve_forever, name="smoke-http", daemon=True)
    thread.start()
    client = HttpClient(server.server_address[1])
    result: dict = {}
    try:
        # ---- health
        live = client.json("GET", "/health/live")
        ready = client.json("GET", "/health/ready")
        info0 = client.json("GET", "/info")[2]
        if live[0] != 200 or ready[2].get("ready") is not True \
                or info0["retrieval"]["corpus_size"] != 0:
            raise AssertionError(f"{phase}: health {live}, ready {ready}, info {info0}")

        # ---- ingest over HTTP only, launches counted
        per_file = len(docs) // 4
        files = [(f"corpus-{k}.txt", "\n\n".join(d.text for d in docs[k * per_file:
                                                                      (k + 1) * per_file]
                                                 ).encode()) for k in range(4)]
        files.append(("guide.html", ("<html><head><style>p{}</style></head><body>" + "".join(
            f"<p>{d.text}</p>" for d in docs[:24]) + "</body></html>").encode()))
        files.append(("notes.docx", docx_bytes([d.text for d in docs[24:40]])))
        want_chunks = expected_chunks(settings, files)
        body, headers = upload_body(files)
        counters = wrappers()
        card0 = card_launches(torch)
        for kernel in counters.values():
            kernel.launches = 0
        t0 = time.perf_counter()
        status, _, upload = client.json("POST", "/upload", body, headers)
        torch.cuda.synchronize()
        ingest_s = time.perf_counter() - t0
        info1 = client.json("GET", "/info")[2]
        embed = client.json("POST", "/embed", {"content": docs[7].text + " " + docs[9].text,
                                               "metadata": {"source": "smoke-embed"}})
        ingest_launches = {name: k.launches for name, k in counters.items()}
        ingest_card = card_delta(torch, card0)
        stored = sum(f.get("chunks_stored", 0) for f in upload["files"])
        result["ingest"] = {"status": status, "files": upload["files"], "seconds": ingest_s,
                            "chunks": stored, "chunks_per_s": stored / ingest_s,
                            "upload_bytes": len(body), "expected_chunks": want_chunks,
                            "corpus_size": info1["retrieval"]["corpus_size"],
                            "embed": embed[2], "launches": ingest_launches,
                            "device_launches": ingest_card}
        emit(f"{phase}_ingest", **result["ingest"])
        if status != 200 or any("error" in f for f in upload["files"]) \
                or len(upload["files"]) != len(files):
            raise AssertionError(f"{phase}: upload failed: {status} {upload}")
        if not stored == info1["retrieval"]["corpus_size"] == want_chunks:
            raise AssertionError(f"{phase}: {stored} chunks stored, /info says "
                                 f"{info1['retrieval']['corpus_size']}, the host's chunker "
                                 f"{want_chunks}")
        if embed[0] != 200 or embed[2]["stats"]["chunks_stored"] <= 0:
            raise AssertionError(f"{phase}: /embed failed: {embed}")
        if ingest_launches["flash_attention"] <= 0:
            raise AssertionError(f"{phase}: ingest never launched the flash kernel")
        check_card(f"{phase}_ingest", ingest_card, ingest_launches)

        # ---- chats: 3 in a row, then 4 JSON + 4 SSE at once
        embed0 = pipeline.embedder.get_stats()
        service.wait_idle()
        stats0, svc0 = engine.stats(), service.stats()
        sub_steps0 = engine.total_sub_steps
        card0 = card_launches(torch)
        for kernel in counters.values():
            kernel.launches = 0
        sequential = []
        for i in range(3):
            t0 = time.perf_counter()
            st, _, out = client.json("POST", "/chat", {
                "question": f"What does the corpus say about {words[60 + i]} and "
                            f"{words[90 + i]}?"})
            sequential.append((st, out, time.perf_counter() - t0))
        start = threading.Barrier(HTTP_CONCURRENT)
        concurrent: list = [None] * HTTP_CONCURRENT

        def chat(i: int) -> None:
            question = f"How is {words[5 * i + 200]} related to {words[5 * i + 201]}?"
            try:
                start.wait(timeout=60)
                t0 = time.perf_counter()
                if i % 2:
                    concurrent[i] = ("sse", client.sse({"question": question}))
                else:
                    st, _, out = client.json("POST", "/chat", {"question": question})
                    concurrent[i] = ("json", (st, out, time.perf_counter() - t0))
            except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
                concurrent[i] = ("raised", exc)

        threads = [threading.Thread(target=chat, args=(i,), name=f"smoke-http-chat-{i}",
                                    daemon=True) for i in range(HTTP_CONCURRENT)]
        t_burst = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
        burst_s = time.perf_counter() - t_burst
        if any(t.is_alive() for t in threads):
            raise AssertionError(f"{phase}: a concurrent chat did not return in time")
        service.wait_idle()
        launches = {name: k.launches for name, k in counters.items()}
        card = card_delta(torch, card0)
        stats1, svc1 = engine.stats(), service.stats()
        sub_steps = engine.total_sub_steps - sub_steps0
        embed1 = pipeline.embedder.get_stats()
        json_s, first_token_s, sse_s = [], [], []
        for i, (st, out, sec) in enumerate(sequential):
            check_http_chat(phase, i, st, out)
            json_s.append(sec)
        for i, (kind, item) in enumerate(concurrent):
            if kind == "raised":
                raise AssertionError(f"{phase} concurrent chat {i} raised: {item!r}") from item
            if kind == "json":
                check_http_chat(phase, 3 + i, item[0], item[1])
                json_s.append(item[2])
            else:
                check_sse_chat(phase, 3 + i, item)
                first_token_s.append(item["first_token_s"])
                sse_s.append(item["seconds"])
        json_sorted = sorted(json_s)
        result["chats"] = {
            "json": len(json_s), "sse": len(sse_s), "json_s": json_s,
            "p50_s": json_sorted[len(json_sorted) // 2],
            "p95_s": json_sorted[min(int(len(json_sorted) * 0.95), len(json_sorted) - 1)],
            "sse_first_token_s": first_token_s, "sse_s": sse_s, "burst_s": burst_s,
            "stage_ms": [out["metadata"]["node_timings_ms"] for _, out, _ in sequential],
            "stage_ms_concurrent": [item[1]["metadata"]["node_timings_ms"]
                                    for kind, item in concurrent if kind == "json"],
            "generated_tokens": [out["metadata"].get("logprob_count")
                                 for _, out, _ in sequential],
            "decode_sub_steps": sub_steps,
            "graph_captures_delta": stats1["graph_captures"] - stats0["graph_captures"],
            "ticks": svc1["ticks"] - svc0["ticks"],
            "shared_ticks": svc1["shared_ticks"] - svc0["shared_ticks"],
            "pump_phase_s": {k: svc1["phase_seconds"][k] - svc0["phase_seconds"][k]
                             for k in svc1["phase_seconds"]},
            "coalescer": {k: embed1["coalescer"][k] - embed0["coalescer"].get(k, 0)
                          for k in ("batches", "items")},
            "coalescer_max_batch": embed1["coalescer"]["max_batch"],
            "embed_cache_hits": embed1["cache"]["hits"] - embed0["cache"]["hits"],
            "query_cache_hits": embed1.get("cache_hits", 0) - embed0.get("cache_hits", 0),
            "launches": launches, "device_launches": card,
            "expected_decode_launches": engine.cfg.n_layers * sub_steps}
        emit(f"{phase}_chats", **result["chats"])
        if result["chats"]["graph_captures_delta"]:
            raise AssertionError(f"{phase}: a graph was captured after warmup")
        if launches["paged_attention"] != engine.cfg.n_layers * sub_steps or sub_steps <= 0 \
                or launches["paged_attention_quant"]:
            raise AssertionError(f"{phase}: decode launches are not one bf16 paged launch per "
                                 f"layer per sub-step: {launches}, {sub_steps} sub-steps")
        if launches["flash_attention"] <= 0:
            raise AssertionError(f"{phase}: the flash kernel never launched: {launches}")
        check_card(phase, card, launches)

        # ---- errors, a client that goes away
        bad = client.json("POST", "/chat", {})
        late = client.json("POST", "/chat", {"question": "anything at all", "deadline_ms": 1})
        # the stream that is left is given DISCONNECT_TOKENS, so it is still
        # decoding when the server sees its client gone
        gen_config = pipeline.generator.config
        pipeline.generator.config = dataclasses.replace(gen_config,
                                                        max_new_tokens=DISCONNECT_TOKENS)
        try:
            sub_steps0, cancelled0 = engine.total_sub_steps, service.stats()["cancelled"]
            gone = client.sse({"question": f"Tell me about {words[300]}."},
                              close_after_first_token=True)
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 30.0:
                s = service.stats()
                if s["active_slots"] == 0 and s["queued"] == 0 and s["queued_inbox"] == 0:
                    break
                time.sleep(0.05)
            idle_s = time.perf_counter() - t0
            gone_sub_steps = engine.total_sub_steps - sub_steps0
            gone_cancelled = service.stats()["cancelled"] - cancelled0
        finally:
            pipeline.generator.config = gen_config
        after = client.json("POST", "/chat", {"question": f"What is {words[301]}?"})
        result["errors"] = {"empty_status": bad[0], "empty_body": bad[2],
                            "deadline_status": late[0], "deadline_code": late[2]["error"]["code"],
                            "disconnect_events": len(gone["events"]),
                            "disconnect_first_token_s": gone["first_token_s"],
                            "idle_after_disconnect_s": idle_s,
                            "disconnect_sub_steps": gone_sub_steps,
                            "disconnect_max_new_tokens": DISCONNECT_TOKENS,
                            "cancelled": gone_cancelled,
                            "after_status": after[0]}
        emit(f"{phase}_errors", **result["errors"])
        if bad[0] != 422 or bad[2].get("error") != "validation_error" \
                or bad[2]["details"][0]["field"] != "question":
            raise AssertionError(f"{phase}: {{}} gave {bad}")
        if late[0] != 504 or late[2]["error"]["code"] != "DEADLINE_EXCEEDED":
            raise AssertionError(f"{phase}: deadline_ms 1 gave {late}")
        if gone["first_token_s"] is None or idle_s >= 30.0 or gone_cancelled != 1 \
                or gone_sub_steps >= DISCONNECT_TOKENS // 2:
            raise AssertionError(f"{phase}: an SSE client that left after its first token was "
                                 f"not cancelled: {gone_cancelled} cancelled, {gone_sub_steps} "
                                 f"of {DISCONNECT_TOKENS} sub-steps decoded, idle after "
                                 f"{idle_s:.1f} s: {service.stats()}")
        check_http_chat(phase, 12, after[0], after[2])

        # ---- /metrics: every chat sent is counted (a stream once its
        # handler has noticed the client left)
        sent = 3 + HTTP_CONCURRENT + 4
        t0 = time.perf_counter()
        while True:
            status, _, text = client.request("GET", "/metrics")
            samples = parse_prometheus(text.decode())
            chats = sum(v for (name, labels), v in samples.items()
                        if name == "sentio_requests_total" and ("endpoint", "/chat") in labels)
            if chats >= sent or time.perf_counter() - t0 > 10.0:
                break
            time.sleep(0.1)
        serving = sorted(dict(labels)["stat"] for (name, labels) in samples
                         if name == "sentio_tpu_serving_stat")
        result["metrics"] = {"status": status, "samples": len(samples), "chat_requests": chats,
                             "chats_sent": sent, "serving_stats": serving}
        emit(f"{phase}_metrics", **result["metrics"])
        if status != 200 or chats != sent or not serving:
            raise AssertionError(f"{phase}: /metrics counts {chats} /chat requests of {sent} "
                                 f"sent, serving stats {serving}")

        # ---- clear, shutdown
        size = client.json("GET", "/info")[2]["retrieval"]["corpus_size"]
        cleared = client.json("POST", "/clear")
        size_after = client.json("GET", "/info")[2]["retrieval"]["corpus_size"]
        if cleared[2].get("documents_removed") != size or size_after != 0:
            raise AssertionError(f"{phase}: /clear removed {cleared} of {size}; "
                                 f"{size_after} left")
    finally:
        t0 = time.perf_counter()
        server.shutdown()
        server.server_close()
        thread.join(timeout=10.0)
        shutdown_s = time.perf_counter() - t0
        pipeline.close()
    result["shutdown_s"] = shutdown_s
    if thread.is_alive() or shutdown_s >= 10.0:
        raise AssertionError(f"{phase}: the server took {shutdown_s:.1f} s to shut down")
    result["pool_bytes"] = engine.pool.hbm_bytes
    del pipeline, engine, service, server
    gc.collect()
    torch.cuda.empty_cache()
    result["memory_allocated_after_close"] = torch.cuda.memory_allocated()
    emit(phase, cleared=cleared[2]["documents_removed"], shutdown_s=shutdown_s,
         pool_bytes=result["pool_bytes"],
         memory_allocated_after_close=result["memory_allocated_after_close"])
    return result


def chunked_slice_check(torch, pipeline, phase: str = "chunked_slice",
                        chunk: int = 512) -> dict:
    """One chunked admission on the slice's own engine (its pool, its
    kernels, its graphs): a prompt of ~3,000 tokens the radix tree does not
    hold past its template head, admitted with ``prefill_chunk=chunk``.
    Gates: prefilled and prefix-hit tokens sum to the prompt, the suffix
    took two segments or more, every decode sub-step was a graph replay
    that ran the pool's paged kernel once per layer, and the other paged
    kernel never ran. Tokens are not held to a whole admission's here (two
    bf16 prefills of different shapes round differently): :func:`chunked_check`
    does that in float32."""
    engine = pipeline.generator.provider.engine
    pipeline.service.wait_idle()  # the engine is driven directly below
    counters = wrappers()
    ran, other = (counters["paged_attention_quant"], counters["paged_attention"])
    if not engine.pool.quantized:
        ran, other = other, ran
    docs = pipeline.index.documents()[1000:1005]  # chunks no chat retrieved
    prompt = pipeline.generator.build_prompt("Which passages repeat a word?", docs)
    before, launches0 = engine.stats(), {name: k.launches for name, k in counters.items()}
    card0 = card_launches(torch)
    engine.prefill_chunk = chunk
    try:
        t0 = time.perf_counter()
        (res,) = engine.run_all([prompt], max_new_tokens=MAX_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        engine.prefill_chunk = None
    deltas = counter_deltas(before, engine.stats())
    counted = {name: k.launches - launches0[name] for name, k in counters.items()}
    card = card_delta(torch, card0)
    launches = {"decode": counted[ran.name], "other": counted[other.name]}
    result = {"prompt_tokens": res.prompt_tokens, "prefill_tokens": res.prefill_tokens,
              "prefix_hit_tokens": res.prefix_hit_tokens,
              "segments": -(-res.prefill_tokens // chunk), "tokens": len(res.tokens),
              "seconds": seconds, "launches": launches, "device_launches": card, **deltas}
    emit(phase, **result)
    if (res.prefill_tokens + res.prefix_hit_tokens != res.prompt_tokens
            or deltas["prefill_tokens_delta"] != res.prefill_tokens):
        raise AssertionError(f"{phase}: prefilled and hit tokens do not make the prompt: {result}")
    if result["segments"] < 2 or not res.tokens:
        raise AssertionError(f"{phase}: expected a multi-segment admission and tokens: {result}")
    sub_steps = deltas["sub_steps_delta"]
    if deltas["graph_replays_delta"] != sub_steps or sub_steps <= 0:
        raise AssertionError(f"{phase}: a decode sub-step was not a graph replay: {result}")
    if launches["decode"] != engine.cfg.n_layers * sub_steps or launches["other"]:
        raise AssertionError(f"{phase}: decode launches are not one per layer per sub-step: "
                             f"{result}")
    check_card(phase, card, counted)
    return result




def profile_chat(torch, pipeline, question: str, phase: str = "profile") -> dict:
    """One more chat (after the counted window) under the CUDA profiler:
    device time by kernel family and the device's idle share of the wall
    time (tracing adds host overhead, so the idle share is an upper bound).
    It also holds the launch counts to the card's own (each kernel's
    device-side count): the pool's paged split kernel and its combine each
    ran exactly once per layer per decode sub-step of the chat (never under
    a draft, whose spec ticks run no paged kernel), as often as the
    wrapper's count says; the other paged family never ran; the flash
    kernel ran as often as its wrapper counted. The profiler's count of each
    device function is reported beside it: the profiler can drop records
    under a chat's ~10^5 kernels, so it is held only to no more than the
    card's count (and the busy time it sums can read low by as much)."""
    from torch.profiler import ProfilerActivity, profile

    engine = pipeline.generator.provider.engine
    counters = wrappers()
    counts0 = {name: k.launches for name, k in counters.items()}
    sub_steps0 = engine.total_sub_steps
    pipeline.service.wait_idle()
    card0 = card_launches(torch)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.chat(question)
        pipeline.service.wait_idle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    card = card_delta(torch, card0)
    sub_steps = engine.total_sub_steps - sub_steps0
    counted = {name: k.launches - counts0[name] for name, k in counters.items()}
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    families = dict.fromkeys((*counters, "matmul", "other"), 0.0)
    by_function = dict.fromkeys(DEVICE_FUNCTIONS, 0.0)  # a paged family split in two
    profiled = dict.fromkeys(DEVICE_FUNCTIONS, 0)
    for name, ms, count in kernels:
        fn = next((fn for fn in DEVICE_FUNCTIONS if fn in name), None)
        if fn is not None:
            by_function[fn] += ms
            profiled[fn] += count
            family = DEVICE_FUNCTIONS[fn][0]
        else:  # cuBLAS names its products gemm / nvjet / xmma kernels
            matmul = any(tag in name.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass"))
            family = "matmul" if matmul else "other"
        families[family] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    decode = "paged_attention_quant" if engine.pool.quantized else "paged_attention"
    # under a draft every tick is a spec tick: no paged kernel runs
    per_decode = 0 if engine.draft_params is not None else engine.cfg.n_layers * sub_steps
    expected = {fn: (per_decode if name == decode
                     else counted["flash_attention"] if name == "flash_attention" else 0)
                for fn, (name, _) in DEVICE_FUNCTIONS.items()}
    result = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
              "device_ms_by_family": families, "device_ms_by_function": by_function,
              "decode_sub_steps": sub_steps, "launches_counted": counted,
              "device_launches": card, "expected_device_launches": expected,
              "profiler_launches": profiled,
              "profiler_missed": {fn: card[fn] - profiled[fn] for fn in card},
              "top_kernels": [{"name": n[:90], "ms": ms, "count": c} for n, ms, c in top]}
    emit(phase, **result)
    if sub_steps <= 0 or card != expected or counted[decode] != per_decode:
        raise AssertionError(f"{phase}: the card's launch counts disagree with the wrappers' "
                             f"or with one per layer per sub-step: {result}")
    if any(profiled[fn] > card[fn] for fn in card):
        raise AssertionError(f"{phase}: the profiler saw launches the card did not count: "
                             f"{result}")
    return result


# ------------------------------------------------------------- speculation

SPEC_K = 4
SPEC_EXACT_TOKENS = 64


def bench_draft_config(target, n_layers: int = 4):
    """bench.py phase E's draft for ``target``: half its width, heads, KV
    heads and MLP, ``n_layers`` layers, its vocabulary, window and rope."""
    from sentio_tpu_torch.models.llama import LlamaConfig

    return LlamaConfig(vocab_size=target.vocab_size, dim=target.dim // 2, n_layers=n_layers,
                       n_heads=target.n_heads // 2, n_kv_heads=max(target.n_kv_heads // 2, 1),
                       mlp_dim=target.mlp_dim // 2, max_len=target.max_len,
                       rope_theta=target.rope_theta, dtype=target.dtype)


def spec_counters(engine) -> dict:
    return {"verifies": engine.spec_verifies_total, "emitted": engine.spec_emitted_total,
            "rounds": engine.spec_rounds_total, "replays": engine.graph_replays,
            "captures": engine.graph_captures, "sub_steps": engine.total_sub_steps}


def close_pipeline(torch, pipeline) -> int:
    """Stop a pipeline's service and free what only it held (its pool, its
    spec caches); returns the bytes the card then holds."""
    import gc

    pipeline.close()
    del pipeline
    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated()


def run_spec_slice(torch, dev, settings, weights: dict, draft: dict) -> dict:
    """slice_spec: the /chat pipeline of ``settings`` with a draft, at full
    width and depth, on the slices' Llama-3-8B tensors: build, warm up (both
    spec round variants captured), ingest, then 3 chats in a counted window
    (each a generate at temperature 0.3, the rejection rule, and a verify at
    0, the greedy rule). Gates: no chat degraded, no paged kernel launched
    (every tick a spec tick), each count equal to the card's (flash), spec
    verifies ran with 1 to k+1 tokens each, every verify admission hit the
    radix tree, no graph captured after warmup."""
    phase = "slice_spec"
    torch.cuda.reset_peak_memory_stats()
    pipeline, docs, words, warm = build_slice(torch, dev, phase, settings, weights, **draft)
    engine = pipeline.generator.provider.engine
    questions = slice_questions(docs, words)
    calls = record_admissions(pipeline.service)
    pipeline.service.wait_idle()
    before = spec_counters(engine)
    try:
        window = chat_window(torch, pipeline, questions)
    finally:
        del pipeline.service.generate  # the recording wrapper
    chats, launches, card = window["chats"], window["launches"], window["card"]
    after = spec_counters(engine)
    moved = {k: after[k] - before[k] for k in after}
    if len(calls) != 2 * len(chats):
        raise AssertionError(f"{phase}: expected a generate and a verify per chat, got "
                             f"{len(calls)} engine calls")
    for i, (response, seconds) in enumerate(chats):
        meta = response["metadata"]
        generate, verify = ({k: v for k, v in c.items() if k != "prompt"}
                            for c in calls[2 * i : 2 * i + 2])
        emit(f"{phase}_chat", index=i, seconds=seconds, stage_ms=meta["stage_ms"],
             generated_tokens=meta["generated_tokens"], answer_chars=len(response["answer"]),
             verdict=response["verification"].get("verdict"), generate=generate, verify=verify)
        check_answered(phase, i, response)
        if verify["prefix_hit_tokens_delta"] <= 0:
            raise AssertionError(f"{phase} chat {i}: the verify admission missed the radix "
                                 f"tree: {verify}")
    spec = engine._spec
    per_verify = moved["emitted"] / moved["verifies"] if moved["verifies"] else 0.0
    result = {"chats": len(chats), "seconds": window["seconds"],
              "chat_s": [sec for _r, sec in chats], "spec_k": engine.spec_k,
              "draft": dataclasses.asdict(engine.draft_cfg), **moved,
              "tokens_per_verify": per_verify, "launches": launches, "device_launches": card,
              "pool_bytes": engine.pool.hbm_bytes, "dense_cache_bytes": spec.dense_bytes,
              "draft_cache_bytes": spec.draft_bytes,
              "engine_stats": {k: v for k, v in engine.stats().items() if k.startswith("spec_")},
              "peak_memory": torch.cuda.max_memory_allocated()}
    emit(phase, **result)
    if launches["paged_attention"] or launches["paged_attention_quant"]:
        raise AssertionError(f"{phase}: a paged kernel ran under speculation: {launches}")
    if launches["flash_attention"] <= 0:
        raise AssertionError(f"{phase}: the flash kernel never launched: {launches}")
    check_card(phase, card, launches)
    if moved["verifies"] <= 0 or not 1.0 <= per_verify <= engine.spec_k + 1:
        raise AssertionError(f"{phase}: no spec verify ran, or tokens per verify outside "
                             f"[1, k+1]: {result}")
    if moved["captures"] or moved["replays"] != moved["rounds"]:
        raise AssertionError(f"{phase}: a capture after warmup, or a round that was not a "
                             f"graph replay: {result}")
    return {"pipeline": pipeline, "launches": launches, "device_launches": card,
            "questions": questions, "words": words, "result": result,
            "generate_prompts": [c["prompt"] for c in calls[0::2]]}


class RoundTrip:
    """Around each spec tick of ``engine`` (an int8 pool): the codes and
    scales of every page lying wholly before its row's first write of the
    tick (the row's length when the tick begins), held before the densify
    and after the scatter back. JAX calls the round trip idempotent."""

    def __init__(self, torch, engine) -> None:
        self.torch, self.spec = torch, engine._ensure_spec()
        self.counts = {"ticks": 0, "pages": 0, "codes": 0, "codes_changed": 0,
                       "max_code_change": 0, "scales": 0, "scales_changed": 0}
        self._begin, self._end, self._held = self.spec.begin, self.spec.end, None
        self.spec.begin, self.spec.end = self.begin, self.end

    def begin(self, st, pool) -> None:
        torch = self.torch
        page = pool.page_size
        table, lens = st.table.tolist(), st.lens.tolist()
        ids = sorted({row[b] for row, n in zip(table, lens) for b in range(n // page) if row[b]})
        idx = torch.tensor(ids, dtype=torch.long, device=st.table.device)
        self._held = (idx, [(p.q[:, idx].clone(), p.s[:, idx].clone())
                            for p in (pool.k, pool.v)])
        self._begin(st, pool)

    def end(self, st, pool) -> None:
        self._end(st, pool)
        idx, held = self._held
        c = self.counts
        c["ticks"] += 1
        c["pages"] += int(idx.numel())
        for (q0, s0), p in zip(held, (pool.k, pool.v)):
            dq = (p.q[:, idx].int() - q0.int()).abs()
            c["codes"] += dq.numel()
            c["codes_changed"] += int((dq != 0).sum())
            c["max_code_change"] = max(c["max_code_change"], int(dq.max()) if dq.numel() else 0)
            c["scales"] += s0.numel()
            c["scales_changed"] += int((p.s[:, idx].view(self.torch.int16)
                                        != s0.view(self.torch.int16)).sum())

    def close(self) -> dict:
        self.spec.begin, self.spec.end = self._begin, self._end
        return self.counts


def agreeing_prefix(a: list, b: list) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


def spec_int8_check(torch, dev, weights: dict, draft: dict, n_layers: int = 4) -> dict:
    """spec_int8: KV_QUANT=int8 with the draft, the slices' target tensors
    cut to ``n_layers`` layers (views, no copy): build, warm up, ingest, 3
    greedy chats. Gates: tokens come out, no paged kernel launched (an int8
    spec tick dequantizes into the dense cache). Reported: how many codes
    and scales of pages wholly before each tick's first write changed over
    the round trip, and, for the chats' generate prompts, how many greedy
    tokens of a bf16 spec engine agree with a bf16 plain engine's before
    the first difference (same cut weights, the paged kernel on the plain
    side)."""
    from sentio_tpu_torch.config import GeneratorConfig, Settings
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine

    phase = "spec_int8"
    cfg = dataclasses.replace(weights["llama_config"], n_layers=n_layers)
    params = {k: v for k, v in weights["llama_params"].items()
              if not k.startswith("layers_") or int(k.split("_")[1]) < n_layers}
    cut = {**weights, "llama_config": cfg, "llama_params": params}
    settings = Settings(generator=GeneratorConfig(kv_quant="int8", max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS))
    pipeline, docs, words, _warm = build_slice(torch, dev, phase, settings, cut, **draft)
    engine = pipeline.generator.provider.engine
    calls = record_admissions(pipeline.service)
    pipeline.service.wait_idle()
    trip = RoundTrip(torch, engine)
    counters = wrappers()
    card0 = card_launches(torch)
    for kernel in counters.values():
        kernel.launches = 0
    chats = []
    try:
        for question in slice_questions(docs, words):
            t0 = time.perf_counter()
            response = pipeline.chat(question, temperature=0.0)
            torch.cuda.synchronize()
            chats.append((response, time.perf_counter() - t0))
    finally:
        del pipeline.service.generate
        drift = trip.close()
    launches = {name: kernel.launches for name, kernel in counters.items()}
    card = card_delta(torch, card0)
    prompts = [c["prompt"] for c in calls[0::2]]
    close_pipeline(torch, pipeline)

    # bf16 spec against bf16 plain on the chats' generate prompts
    geometry = dict(max_slots=8, page_size=128, max_pages_per_seq=64, steps_per_tick=16,
                    max_tick_steps=64, pipeline_depth=2, device=dev)
    agree = []
    for use_draft in (False, True):
        kw = draft if use_draft else {}
        eng = ContinuousBatchingEngine(model_config=cfg, params=params, **geometry, **kw)
        agree.append([r.tokens for r in eng.run_all(prompts, max_new_tokens=MAX_TOKENS)])
        del eng
    torch.cuda.empty_cache()
    result = {"model": {"n_layers": n_layers, "kv_quant": "int8"},
              "chats": [{"seconds": sec, "generated_tokens": r["metadata"]["generated_tokens"],
                         "answer_chars": len(r["answer"])} for r, sec in chats],
              "launches": launches, "device_launches": card, "round_trip": drift,
              "bf16_spec_vs_plain": {
                  "tokens": [len(t) for t in agree[1]],
                  "agreeing_prefix": [agreeing_prefix(a, b) for a, b in zip(*agree)],
                  "equal": [a == b for a, b in zip(*agree)]}}
    emit(phase, **result)
    if any(not r["metadata"]["generated_tokens"] or not r["answer"] for r, _s in chats):
        raise AssertionError(f"{phase}: a chat generated no tokens: {result}")
    if launches["paged_attention_quant"] or launches["paged_attention"]:
        raise AssertionError(f"{phase}: a paged kernel ran under speculation: {launches}")
    check_card(phase, card, launches)
    if drift["ticks"] <= 0 or drift["pages"] <= 0:
        raise AssertionError(f"{phase}: no spec tick held a page to measure: {drift}")
    return result


def spec_exact_check(torch, dev, prompts: list) -> dict:
    """spec_exact: float32 at Llama-3-8B width cut to 2 layers, greedy, on
    both engines, each prompt decoded SPEC_EXACT_TOKENS tokens: a perfect
    draft (the target's own tensors) and a weak one (bench.py's draft
    geometry at 2 layers). Gates: every spec run's tokens equal its
    engine's plain tokens; the perfect draft gives at least k tokens a
    verify on both engines (a row's tokens over the contiguous decoder's
    rounds). Plain attention (the kernels take bf16):
    the paged engine's plain decode, the contiguous prefills plain. Then
    the contiguous decoder in bf16 with the flash kernel: its target and
    draft prefills launch flash once per layer each, the card's count the
    same."""
    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla
    from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder

    phase = "spec_exact"
    n = SPEC_EXACT_TOKENS
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(SEED + 7), dev)
    dcfg = bench_draft_config(cfg, n_layers=2)
    dparams = init_llama(dcfg, torch.Generator(device=dev).manual_seed(SEED + 8), dev)
    drafts = {"perfect": (params, cfg), "weak": (dparams, dcfg)}
    geometry = dict(max_slots=8, page_size=128, max_pages_per_seq=64, steps_per_tick=16,
                    max_tick_steps=64, pipeline_depth=2, device=dev)
    runs, tokens = {}, {}

    def paged(name):
        kw = {}
        if name != "plain":
            kw = dict(draft_params=drafts[name][0], draft_config=drafts[name][1], spec_k=SPEC_K)
        eng = ContinuousBatchingEngine(model_config=cfg, params=params, **geometry, **kw)
        eng.attn_impl = _paged_attn_xla
        t0 = time.perf_counter()
        results = eng.run_all(prompts, max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        runs[f"paged_{name}"] = {"seconds": time.perf_counter() - t0,
                                 "tokens": [len(r.tokens) for r in results],
                                 "finish_reason": [r.finish_reason for r in results],
                                 **({k: v for k, v in eng.stats().items()
                                     if k.startswith("spec_")}),
                                 "rounds": eng.spec_rounds_total,
                                 "graph_replays": eng.graph_replays}
        tokens[f"paged_{name}"] = [r.tokens for r in results]

    contig = GeneratorEngine(config=GeneratorConfig(max_new_tokens=n, dtype="float32"),
                             model_config=cfg, params=params, device=dev)
    contig.attn_fn = None

    def contiguous(name):
        gen = contig if name == "plain" else SpeculativeDecoder(contig, *drafts[name], k=SPEC_K)
        t0 = time.perf_counter()
        results = gen.generate(prompts, max_new_tokens=n, temperature=0.0)
        torch.cuda.synchronize()
        runs[f"contig_{name}"] = {"seconds": time.perf_counter() - t0,
                                  "tokens": [len(r.tokens) for r in results],
                                  "finish_reason": [r.finish_reason for r in results],
                                  **({"stats": gen.stats,
                                      "tokens_per_verify": gen.tokens_per_round / len(prompts)}
                                     if name != "plain" else {})}
        tokens[f"contig_{name}"] = [r.tokens for r in results]

    for name in ("plain", "perfect", "weak"):
        paged(name)
        contiguous(name)
    del contig
    torch.cuda.empty_cache()

    del params, dparams, drafts
    torch.cuda.empty_cache()
    # the contiguous decoder with flash prefills, in bf16 (random from the
    # same seeds; the kernel takes bf16)
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    bdcfg = dataclasses.replace(dcfg, dtype="bfloat16")
    bf_params = init_llama(bf, torch.Generator(device=dev).manual_seed(SEED + 7), dev)
    bf_draft = init_llama(bdcfg, torch.Generator(device=dev).manual_seed(SEED + 8), dev)
    engine = GeneratorEngine(config=GeneratorConfig(max_new_tokens=n), model_config=bf,
                             params=bf_params, device=dev)
    decoder = SpeculativeDecoder(engine, bf_draft, bdcfg, k=SPEC_K)
    flash = wrappers()["flash_attention"]
    torch.cuda.synchronize()
    card0 = card_launches(torch)
    flash.launches = 0
    results = decoder.generate(prompts, max_new_tokens=n, temperature=0.0)
    flash_launches = flash.launches
    card = card_delta(torch, card0)
    runs["contig_bf16_flash"] = {"prefills": decoder.prefills, "stats": decoder.stats,
                                 "flash_launches": flash_launches,
                                 "device_launches": family_launches(card, "flash_attention"),
                                 "tokens": [len(r.tokens) for r in results]}
    prefills = decoder.prefills
    del engine, decoder, bf_params, bf_draft
    torch.cuda.empty_cache()

    equal = {key: tokens[key] == tokens[key.split("_")[0] + "_plain"]
             for key in tokens if not key.endswith("plain")}
    result = {"model": {"dim": cfg.dim, "n_layers": cfg.n_layers, "dtype": cfg.dtype,
                        "draft_dim": dcfg.dim, "draft_layers": dcfg.n_layers},
              "prompts": len(prompts), "new_tokens": n, "spec_k": SPEC_K, "runs": runs,
              "tokens_equal": equal,
              "first_difference": {key: next((i for i, (a, b) in enumerate(
                  zip(tokens[key], tokens[key.split("_")[0] + "_plain"])) if a != b), None)
                  for key in equal},
              "launches": {"flash_attention": flash_launches}, "device_launches": card}
    emit(phase, **result)
    if not all(equal.values()):
        raise AssertionError(f"{phase}: speculative tokens differ from plain tokens: {equal}")
    if (runs["paged_perfect"].get("spec_tokens_per_verify", 0) < SPEC_K
            or runs["contig_perfect"]["tokens_per_verify"] < SPEC_K):
        raise AssertionError(f"{phase}: the perfect draft gave fewer than k tokens a verify: "
                             f"{runs['paged_perfect']}, {runs['contig_perfect']}")
    if flash_launches != bf.n_layers + bdcfg.n_layers or prefills != 2:
        raise AssertionError(f"{phase}: the contiguous decoder's prefills did not launch flash "
                             f"once per layer each: {runs['contig_bf16_flash']}")
    check_card(phase, card, {"paged_attention": 0, "paged_attention_quant": 0,
                             "flash_attention": flash_launches})
    return result


# ------------------------------------------------- training and the eval


# train-encoder's CLI defaults (JAX's): dim 256, 4 layers, 600 steps of 64
TRAIN_DIM, TRAIN_LAYERS = 256, 4
# the serving embedder's width (EncoderConfig.base()), a few steps
WIDE_DIM, WIDE_LAYERS, WIDE_STEPS = 1024, 24, 20
EVAL_QUERIES_GATES = 16
VERDICT_WAIT_S = 30.0


def encoder_config(dim: int, layers: int):
    """The encoder ``python -m sentio_tpu_torch train-encoder`` trains."""
    from sentio_tpu_torch.models.transformer import EncoderConfig

    return EncoderConfig(vocab_size=512, dim=dim, n_layers=layers, n_heads=max(dim // 64, 2),
                         mlp_dim=dim * 4, max_len=512)


class LaunchWindow:
    """Every wrapper's count set to 0 at the start and read at the end,
    beside the card's own counts of the same window."""

    def __init__(self, torch) -> None:
        self.torch = torch
        self.counters = wrappers()
        self.card0 = card_launches(torch)
        for kernel in self.counters.values():
            kernel.launches = 0

    def read(self) -> tuple[dict, dict]:
        launches = {name: k.launches for name, k in self.counters.items()}
        return launches, card_delta(self.torch, self.card0)


def train_encoder_check(torch, dev, out_dir: str) -> dict:
    """train_encoder at JAX's CLI defaults on the card: float32 master
    weights, bf16 compute, AdamW, 600 steps of 64 pairs; the checkpoint to
    ``out_dir``. Reported: the loss at step 0 and at the end, the median
    step ms, wall seconds, peak memory, recall@10 on the eval bundle for
    the trained encoder and for the same config untrained (each through the
    serving embedder: the flash kernel, its launches held to the card's).
    Gates: the loss fell; trained recall above untrained; the checkpoint
    reads back equal through the port's reader and serves through
    ``EMBEDDER_CHECKPOINT`` in ``build_pipeline``."""
    import statistics

    from sentio_tpu_torch.config import EmbedderConfig, GeneratorConfig, Settings
    from sentio_tpu_torch.eval.train_encoder import (
        TrainConfig,
        eval_recall,
        param_leaves,
        train_encoder,
    )
    from sentio_tpu_torch.models.transformer import init_encoder
    from sentio_tpu_torch.pipeline import build_pipeline
    from sentio_tpu_torch.runtime.weights import load_model

    phase = "train_encoder"
    cfg = encoder_config(TRAIN_DIM, TRAIN_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, cfg, hist = train_encoder(enc_cfg=cfg, train_cfg=TrainConfig(), out_path=out_dir,
                                      seed=SEED, device=dev)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    window = LaunchWindow(torch)
    trained = eval_recall(params, cfg, device=dev)
    launches, card = window.read()
    untrained = eval_recall(init_encoder(cfg, torch.Generator(device=dev).manual_seed(SEED),
                                         dev, dtype=torch.float32), cfg, device=dev)
    loaded, loaded_cfg = load_model(out_dir, expect_family="encoder", device=dev)
    same = all(torch.equal(a, b) for a, b in zip(param_leaves(params), param_leaves(loaded)))
    settings = Settings(embedder=EmbedderConfig(checkpoint_path=out_dir),
                        generator=GeneratorConfig(model_preset="tiny", kv_page_size=16,
                                                  kv_max_pages_per_seq=64))
    pipeline = build_pipeline(settings, device=dev, seed=SEED)
    try:
        served_cfg = pipeline.embedder.model_config
        served = all(torch.equal(a, b) for a, b in zip(param_leaves(params),
                                                       param_leaves(pipeline.embedder.params)))
        probe = "who designed the aurora compiler?"
        direct = eval_embed(torch, params, cfg, dev, probe)
        via_pipeline = torch.as_tensor(pipeline.embedder.embed_many([probe])[0])
        embed_err = float((direct - via_pipeline).abs().max())
    finally:
        pipeline.close()
    step_ms = hist["step_ms"]
    result = {"config": dataclasses.asdict(cfg), "steps": hist["steps"], "pairs": hist["pairs"],
              "loss_first": hist["loss"][0][1], "loss_last": hist["loss"][-1][1],
              "loss": hist["loss"], "step_ms_median": statistics.median(step_ms),
              "step_ms_first": step_ms[0], "wall_s": wall_s, "peak_memory": peak,
              "recall_at_10_trained": trained, "recall_at_10_untrained": untrained,
              "eval_recall_launches": launches, "eval_recall_device_launches": card,
              "checkpoint_reads_back_equal": same, "checkpoint_config_equal": loaded_cfg == cfg,
              "embedder_checkpoint_params_equal": served,
              "embedder_checkpoint_config_equal": served_cfg == cfg,
              "embedder_checkpoint_embed_err": embed_err}
    emit(phase, **result)
    if not result["loss_last"] < result["loss_first"]:
        raise AssertionError(f"{phase}: the loss did not fall: {hist['loss']}")
    if not trained > untrained:
        raise AssertionError(f"{phase}: trained recall@10 {trained} is not above the "
                             f"untrained {untrained}")
    if not (same and loaded_cfg == cfg and served and served_cfg == cfg and embed_err == 0.0):
        raise AssertionError(f"{phase}: the checkpoint does not read back or serve as "
                             f"trained: {result}")
    if launches["flash_attention"] <= 0:
        raise AssertionError(f"{phase}: eval_recall never launched the flash kernel")
    check_card(phase, card, launches)
    return {**result, "params": params, "cfg": cfg}


def eval_embed(torch, params, cfg, dev, text: str):
    """One text through a fresh serving embedder over ``params``."""
    from sentio_tpu_torch.config import EmbedderConfig
    from sentio_tpu_torch.ops.embedder import TorchEmbedder

    embedder = TorchEmbedder(EmbedderConfig(), params=params, model_config=cfg, device=dev)
    try:
        return torch.as_tensor(embedder.embed_many([text])[0])
    finally:
        embedder.close()


def train_encoder_wide_check(torch, dev) -> dict:
    """20 training steps at the serving embedder's width (dim 1,024, 24
    layers, 16 heads) with train-encoder's other defaults, in bf16 compute
    (step ms, peak memory) and again in float32 compute from the same
    float32 masters. JAX's recipe collapses at this depth within these 20
    steps (every embedding alike, the loss at ln(batch)), in float32 as in
    bf16, so the loss is reported, not required to fall. Gates: every loss
    finite in both runs; step 0's loss in bf16 within 5e-2 of float32's
    (the same batch and weights; step 0 has lr 0); the masters of every
    layer moved in both (gradients reach all 24 layers)."""
    import math
    import statistics

    from sentio_tpu_torch.eval.train_encoder import TrainConfig, param_leaves, train_encoder
    from sentio_tpu_torch.models.transformer import init_encoder

    phase = "train_encoder_wide"
    cfg = encoder_config(WIDE_DIM, WIDE_LAYERS)
    init = init_encoder(cfg, torch.Generator(device=dev).manual_seed(SEED), dev,
                        dtype=torch.float32)

    def run(dtype: str) -> dict:
        run_cfg = dataclasses.replace(cfg, dtype=dtype)
        params = {k: _clone(v) for k, v in init.items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        params, _cfg, hist = train_encoder(enc_cfg=run_cfg,
                                           train_cfg=TrainConfig(steps=WIDE_STEPS), seed=SEED,
                                           log_every=1, device=dev, params=params)
        moved = [i for i in range(WIDE_LAYERS) if not torch.equal(
            params[f"layers_{i}"]["attn"]["wq"]["weight"],
            init[f"layers_{i}"]["attn"]["wq"]["weight"])]
        out = {"loss": [v for _i, v in hist["loss"]],
               "step_ms_median": statistics.median(hist["step_ms"][1:]),
               "step_ms_first": hist["step_ms"][0], "wall_s": time.perf_counter() - t0,
               "peak_memory": torch.cuda.max_memory_allocated() - base,
               "layers_moved": len(moved)}
        out["collapsed"] = abs(out["loss"][-1] - math.log(TrainConfig().batch)) < 1e-3
        del params
        return out

    runs = {"bfloat16": run("bfloat16"), "float32": run("float32")}
    result = {"config": dataclasses.asdict(cfg), "steps": WIDE_STEPS,
              "params": sum(x.numel() for x in param_leaves(init)), **runs["bfloat16"],
              "float32": runs["float32"]}
    del init
    torch.cuda.empty_cache()
    emit(phase, **result)
    for dtype, r in runs.items():
        if not all(math.isfinite(v) for v in r["loss"]) or r["layers_moved"] != WIDE_LAYERS:
            raise AssertionError(f"{phase} {dtype}: a loss is not finite, or a layer did not "
                                 f"train: {r}")
    if abs(runs["bfloat16"]["loss"][0] - runs["float32"]["loss"][0]) > 5e-2:
        raise AssertionError(f"{phase}: step 0's loss in bf16 {runs['bfloat16']['loss'][0]} "
                             f"against float32 {runs['float32']['loss'][0]}")
    return result


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def eval_check(torch, dev, checkpoint: str) -> dict:
    """run_eval(scale="bench") at its defaults (1,024 documents, 64
    queries, concurrency 8, 48 new tokens) with the trained encoder, each
    configuration in a launch window of its own. Gates: every row has 64
    queries and no error; flash launched in ``dense`` and
    ``hybrid_rerank``, the bf16 paged kernel in ``full_paged`` and
    ``batched`` (the int8 one never), each count equal to the card's."""
    from sentio_tpu_torch.eval.runner import run_eval

    phase = "eval"
    windows: dict = {}
    counts: dict = {}

    def on_config(name: str, starting: bool) -> None:
        if starting:
            windows[name] = LaunchWindow(torch)
        else:
            launches, card = windows.pop(name).read()
            counts[name] = {"launches": launches, "device_launches": card}

    payload = run_eval(scale="bench", encoder_checkpoint=checkpoint, device=dev,
                       on_config=on_config)
    for row in payload["rows"]:
        emit(f"{phase}_row", **row)
    emit(f"{phase}_baseline", **(payload["baseline"] or {}))
    emit(f"{phase}_north_star", **payload.get("north_star", {}))
    emit(phase, **{k: v for k, v in payload.items() if k not in ("rows", "baseline")},
         launches=counts)
    rows = {r["config"]: r for r in payload["rows"]}
    if len(rows) != 5 or any(r["n"] != 64 or r.get("errors", 0) for r in rows.values()):
        raise AssertionError(f"{phase}: rows {payload['rows']}")
    if payload["platform"]["backend"] != "gpu" or not payload.get("north_star"):
        raise AssertionError(f"{phase}: platform {payload['platform']}, "
                             f"north star {payload.get('north_star')}")
    for name, kernel in (("dense", "flash_attention"), ("hybrid_rerank", "flash_attention"),
                         ("full_paged", "paged_attention"), ("batched", "paged_attention")):
        launches = counts[name]["launches"]
        if launches[kernel] <= 0 or launches["paged_attention_quant"]:
            raise AssertionError(f"{phase} {name}: {kernel} never launched, or the int8 "
                                 f"kernel did: {launches}")
    for name, c in counts.items():
        check_card(f"{phase} {name}", c["device_launches"], c["launches"])
    return {"payload": payload, "counts": counts}


def quality_gates_check(torch, dev, checkpoint: str) -> dict:
    """The JAX package's two committed quality gates, held on the card
    against the port's copies of the files, at bench scale over
    ``full_paged`` with 16 queries: bf16 (sync) against int8
    (``quant_gate.json``; the int8 run's decode through the int8 kernel,
    its count equal to the card's), and sync against gated
    (``verify_gate.json``)."""
    from pathlib import Path

    import sentio_tpu_torch.eval as eval_pkg
    from sentio_tpu_torch.eval.runner import run_eval

    phase = "quality_gates"
    gate_dir = Path(eval_pkg.__file__).parent
    quant_gate = json.loads((gate_dir / "quant_gate.json").read_text())
    verify_gate = json.loads((gate_dir / "verify_gate.json").read_text())
    args = dict(scale="bench", n_queries=EVAL_QUERIES_GATES, skip_baseline=True,
                configs={"full_paged"}, encoder_checkpoint=checkpoint, device=dev)
    runs, counts = {}, {}
    for name, extra in (("bf16", {}), ("int8", {"kv_quant": "int8"}),
                        ("gated", {"verify_mode": "gated"})):
        window = {}

        def on_config(_config: str, starting: bool, window=window) -> None:
            if starting:
                window["w"] = LaunchWindow(torch)
            else:
                window["counts"] = window.pop("w").read()

        runs[name] = run_eval(**args, **extra, on_config=on_config)["rows"][0]
        launches, card = window["counts"]
        counts[name] = {"launches": launches, "device_launches": card}
        check_card(f"{phase} {name}", card, launches)
    bf, i8, gated = runs["bf16"], runs["int8"], runs["gated"]
    drop = bf["recall@10"] - i8["recall@10"]
    ratio = i8.get("answer_chars_mean", 0.0) / max(bf.get("answer_chars_mean", 0.0), 1e-9)
    sync_v, gated_v = bf.get("verdicts") or {}, gated.get("verdicts") or {}
    common = set(sync_v) & set(gated_v)
    agree = sum(1 for q in common if gated_v[q] == sync_v[q]
                or (gated_v[q] == "skipped_confident" and sync_v[q] == "pass"))
    agreement = agree / len(common) if common else 0.0
    skip_rate = gated.get("verify_skip_rate", 0.0)
    result = {"rows": runs, "launches": counts,
              "quant": {"recall_drop": drop, "answer_chars_ratio": ratio,
                        "int8_errors": i8.get("errors", 0), "gate": quant_gate},
              "verify": {"agreement": agreement, "common": len(common), "skip_rate": skip_rate,
                         "gated_errors": gated.get("errors", 0), "gate": verify_gate}}
    emit(phase, **result)
    if counts["int8"]["launches"]["paged_attention_quant"] <= 0 \
            or counts["int8"]["launches"]["paged_attention"] \
            or counts["bf16"]["launches"]["paged_attention"] <= 0:
        raise AssertionError(f"{phase}: decode did not go through the pool's kernel: {counts}")
    if i8.get("errors", 0) > quant_gate["errors_max"] \
            or drop > quant_gate["recall_at_10_max_drop"] \
            or bf.get("answer_chars_mean", 0.0) <= 0 \
            or ratio < quant_gate["answer_chars_min_ratio"]:
        raise AssertionError(f"{phase}: the int8 quality gate failed: {result['quant']}, "
                             f"{bf} vs {i8}")
    if not common or gated.get("errors", 0) > verify_gate["errors_max"] \
            or agreement < verify_gate["min_verdict_agreement"] \
            or skip_rate > verify_gate["max_skip_rate"]:
        raise AssertionError(f"{phase}: the verify gate failed: {result['verify']}, "
                             f"{sync_v} vs {gated_v}")
    return result


def flight_verdict(client, query_id: str, timeout_s: float = VERDICT_WAIT_S):
    """Poll ``/debug/flight/{query_id}`` until its verify section has an
    outcome; returns (seconds waited, the verify section) or (None, the
    last record)."""
    t0 = time.perf_counter()
    record = None
    while time.perf_counter() - t0 < timeout_s:
        status, _, record = client.json("GET", f"/debug/flight/{query_id}")
        if status == 200 and (record or {}).get("verify", {}).get("outcome"):
            return time.perf_counter() - t0, record["verify"]
        time.sleep(0.05)
    return None, record


def verify_modes_check(torch, dev, shared) -> dict:
    """VERIFY_MODE on the HTTP server at Llama-3-8B width: one pipeline
    under ``Settings()`` (hybrid, bf16 pool) on ``shared``'s weights, its
    mode switched between rounds (the pipeline and the handlers read it at
    each chat; nothing is in flight at a switch). ``sync``: 3 JSON chats.
    ``async``: 3 JSON chats, each back with ``verify_pending`` and its
    verdict in ``/debug/flight/{id}`` within 30 s, and one SSE chat whose
    ``[DONE]`` comes before its ``verify`` event. ``gated`` at the default
    threshold (the skip rate reported), then at threshold 0: every verdict
    ``skipped_confident`` and no verify admission on the service. Reported:
    time to the answer under each mode against ``sync``'s."""
    import tempfile
    import threading

    from sentio_tpu_torch.config import GeneratorConfig, Settings
    from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
    from sentio_tpu_torch.pipeline import wait_detached
    from sentio_tpu_torch.serve.app import create_server

    phase = "verify_modes"
    settings = Settings(generator=GeneratorConfig(max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS))
    pipeline, _docs, words, _warm = build_slice(torch, dev, phase, settings, shared)
    service, gcfg = pipeline.service, settings.generator
    server = create_server(settings, pipeline, host="127.0.0.1", port=0,
                           fallback=(FallbackResponseCache(tempfile.mkdtemp(
                               prefix="smoke-fallback-")), LLMFallback()))
    thread = threading.Thread(target=server.serve_forever, name="smoke-verify-http",
                              daemon=True)
    thread.start()
    client = HttpClient(server.server_address[1])
    # every admission through the service's one blocking entry point (each
    # JSON chat's generate and each verify)
    generates: list = []
    generate = service.generate

    def counted(prompt, **kwargs):
        generates.append(prompt)
        return generate(prompt, **kwargs)

    service.generate = counted
    rounds: dict = {}
    window = LaunchWindow(torch)

    def round_of(mode: str, threshold: float, offset: int) -> dict:
        gcfg.verify_mode, gcfg.verify_confidence_threshold = mode, threshold
        service.wait_idle()
        calls0, done0 = len(generates), service.stats()["completed"]
        chats = []
        for i in range(3):
            question = f"What does the corpus say about {words[(offset + i) % len(words)]}?"
            t0 = time.perf_counter()
            status, _, body = client.json("POST", "/chat", {"question": question})
            chats.append({"status": status, "answer_s": time.perf_counter() - t0,
                          "body": body})
        return {"mode": mode, "threshold": threshold, "chats": chats,
                "calls0": calls0, "completed0": done0}

    try:
        rounds["sync"] = round_of("sync", 0.75, 400)
        rounds["async"] = round_of("async", 0.75, 410)
        for chat in rounds["async"]["chats"]:
            chat["verdict_wait_s"], chat["flight_verify"] = flight_verdict(
                client, chat["body"]["metadata"]["query_id"])
        wait_detached()
        sse = client.sse({"question": f"Tell me about {words[420 % len(words)]}."},
                         after_done=True)
        wait_detached()
        rounds["gated"] = round_of("gated", 0.75, 430)
        for chat in rounds["gated"]["chats"]:
            meta = chat["body"]["metadata"]
            if meta.get("verify_pending"):
                chat["verdict_wait_s"], chat["flight_verify"] = flight_verdict(
                    client, meta["query_id"])
        wait_detached()
        rounds["gated_0"] = round_of("gated", 0.0, 440)
        wait_detached()
        service.wait_idle()
        gated0_admissions = len(generates) - rounds["gated_0"]["calls0"]
        gated0_completed = service.stats()["completed"] - rounds["gated_0"]["completed0"]
        flights = {chat["body"]["metadata"]["query_id"]: client.json(
            "GET", f"/debug/flight/{chat['body']['metadata']['query_id']}")[2]
            for chat in rounds["gated_0"]["chats"]}
        launches, card = window.read()
    finally:
        del service.generate  # the counting wrapper
        gcfg.verify_mode, gcfg.verify_confidence_threshold = "sync", 0.75
        server.shutdown()
        server.server_close()
        thread.join(timeout=10.0)
        pipeline.close()

    for i, chat in enumerate(rounds["sync"]["chats"]):
        check_http_chat(f"{phase} sync", i, chat["status"], chat["body"])
    summary = {}
    for name, r in rounds.items():
        answer_s = [c["answer_s"] for c in r["chats"]]
        summary[name] = {
            "threshold": r["threshold"], "answer_s": answer_s,
            "verdicts": [(c["body"]["metadata"].get("evaluation") or {}).get("verdict")
                         for c in r["chats"]],
            "verify_pending": [bool(c["body"]["metadata"].get("verify_pending"))
                               for c in r["chats"]],
            "confidence": [c["body"]["metadata"].get("verify_confidence") for c in r["chats"]],
            "flight_verify": [c.get("flight_verify") for c in r["chats"]],
            "verdict_wait_s": [c.get("verdict_wait_s") for c in r["chats"]],
            "stage_ms": [c["body"]["metadata"].get("node_timings_ms") for c in r["chats"]]}
    sync_s = sorted(summary["sync"]["answer_s"])[1]
    gated_default = summary["gated"]
    skips = sum(v == "skipped_confident" for v in gated_default["verdicts"])
    kinds = [e if e == "[DONE]" else next(iter(e)) for e in sse["events"]]
    result = {"rounds": summary, "answer_s_median": {
                  name: sorted(s["answer_s"])[1] for name, s in summary.items()},
              "answer_s_vs_sync": {name: sorted(s["answer_s"])[1] / sync_s
                                   for name, s in summary.items()},
              "gated_skip_rate": skips / 3, "gated_0_verify_admissions": gated0_admissions,
              "gated_0_completed": gated0_completed,
              "gated_0_flight": [f.get("verify") for f in flights.values()],
              "sse": {"status": sse["status"], "events": kinds,
                      "first_token_s": sse["first_token_s"], "done_s": sse.get("done_s"),
                      "seconds": sse["seconds"]},
              "launches": launches, "device_launches": card}
    emit(phase, **result)
    for i, chat in enumerate(rounds["async"]["chats"]):
        meta = chat["body"]["metadata"]
        if chat["status"] != 200 or meta.get("degraded") or not chat["body"].get("answer") \
                or meta.get("verify_pending") is not True or "evaluation" in meta:
            raise AssertionError(f"{phase} async chat {i}: not answered before its audit: "
                                 f"{chat['status']} {meta}")
        if chat["verdict_wait_s"] is None or chat["flight_verify"].get("mode") != "async":
            raise AssertionError(f"{phase} async chat {i}: no verdict in /debug/flight "
                                 f"within {VERDICT_WAIT_S} s: {chat['flight_verify']}")
    if sse["status"] != 200 or "[DONE]" not in kinds or kinds[-1] != "verify" \
            or kinds.index("[DONE]") > kinds.index("verify") or "token" not in kinds:
        raise AssertionError(f"{phase}: the async SSE chat's events {kinds}")
    for i, chat in enumerate(rounds["gated"]["chats"]):
        meta = chat["body"]["metadata"]
        pending = meta.get("verify_pending") is True
        skipped = (meta.get("evaluation") or {}).get("verdict") == "skipped_confident"
        if chat["status"] != 200 or meta.get("degraded") or pending == skipped \
                or (pending and chat.get("verdict_wait_s") is None):
            raise AssertionError(f"{phase} gated chat {i}: {chat['status']} {meta}")
    for i, chat in enumerate(rounds["gated_0"]["chats"]):
        meta = chat["body"]["metadata"]
        if chat["status"] != 200 or meta.get("evaluation", {}).get("verdict") \
                != "skipped_confident" or meta.get("verify_pending"):
            raise AssertionError(f"{phase} gated threshold 0 chat {i}: {meta}")
    if gated0_admissions != 3 or gated0_completed != 3 or any(
            (f.get("verify") or {}).get("outcome") != "skipped_confident"
            for f in flights.values()):
        raise AssertionError(f"{phase}: threshold 0 made verify admissions: "
                             f"{gated0_admissions} admissions for 3 chats, {flights}")
    if launches["paged_attention"] <= 0 or launches["flash_attention"] <= 0:
        raise AssertionError(f"{phase}: a kernel never launched: {launches}")
    check_card(phase, card, launches)
    return result


# ------------------------------------------------------------ the replica tier

REPLICA_JSON_CHATS = 8   # with REPLICA_SSE_CHATS, released together from two tenants
REPLICA_SSE_CHATS = 2
REPLICA_ROUNDS = 3       # bursts of each replica count, each on questions of its own
# AFFINITY_STICKINESS of the replica phases: a replica keeps the chats its
# radix tree serves best while its backlog is within 0.5 x its 8 slots. The
# router takes the first of replicas tied at the best hit, as JAX's does,
# and every burst prompt shares its first ROUTE_PREFIX_TOKENS (512) with
# the others on random weights (the template head, then the same top
# document), so at JAX's default of 4 (32 requests) replica 0 would take
# the whole burst
REPLICA_STICKINESS = 0.5
STALL_BUDGET_S = 5.0     # TICK_STALL_BUDGET_S in the replica_stall phase
RESUME_TOKENS = 256      # the float32 resume stream; its ticks are 16 sub-steps
RESUME_TOKENS_BF16 = 128


def percentile(values: list, q: float) -> float:
    values = sorted(values)
    return values[min(int(len(values) * q), len(values) - 1)]


def wait_for(predicate, timeout_s: float, what: str, poll_s: float = 0.05):
    end = time.perf_counter() + timeout_s
    while time.perf_counter() < end:
        value = predicate()
        if value:
            return value
        time.sleep(poll_s)
    raise AssertionError(f"timed out after {timeout_s:.0f} s waiting for {what}")


def replica_health(client) -> tuple[int, dict]:
    status, _, body = client.json("GET", "/health")
    return status, body


def fail_replica_steps(engine, point: str) -> None:
    """A fault point of ``engine``'s own ticks, hit where ``paged.step``
    is (before any device work): the drills below arm it to fail or wedge
    one replica while its sibling serves (``paged.step`` is shared by every
    engine of the process)."""
    from sentio_tpu_torch.infra import faults

    step = engine.step

    def step_with_fault():
        faults.hit(point)
        return step()

    engine.step = step_with_fault


def http_burst(client, words, n_json: int, n_sse: int, offset: int) -> list:
    """``n_json`` JSON and ``n_sse`` SSE chats at once, alternating tenants
    ``a`` and ``b`` (``X-Tenant``); each result with its seconds."""
    import threading

    total = n_json + n_sse
    out: list = [None] * total
    start = threading.Barrier(total)

    def run(i: int) -> None:
        question = f"What links {words[offset + 3 * i]} to {words[offset + 3 * i + 1]}?"
        headers = {"X-Tenant": "ab"[i % 2]}
        start.wait(timeout=60)
        t0 = time.perf_counter()
        try:
            if i < n_json:
                status, _, body = client.json("POST", "/chat", {"question": question},
                                              headers)
                out[i] = ("json", status, body, time.perf_counter() - t0)
            else:
                out[i] = ("sse", client.sse({"question": question}, headers=headers), None,
                          time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            out[i] = ("raised", exc, None, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,), name=f"smoke-burst-{i}", daemon=True)
               for i in range(total)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"a burst chat did not return within {HTTP_TIMEOUT_S:.0f} s")
    return out


def check_burst(phase: str, out: list) -> dict:
    for i, (kind, a, b, _s) in enumerate(out):
        if kind == "raised":
            raise AssertionError(f"{phase} chat {i} raised: {a!r}") from a
        if kind == "json":
            check_http_chat(phase, i, a, b)
        else:
            check_sse_chat(phase, i, a)
    seconds = [s for *_x, s in out]
    json_s = [s for kind, *_x, s in out if kind == "json"]
    return {"chat_s": seconds, "p50_s": percentile(seconds, 0.5),
            "p95_s": percentile(seconds, 0.95), "json_p50_s": percentile(json_s, 0.5),
            "json_p95_s": percentile(json_s, 0.95),
            "sse_first_token_s": [a["first_token_s"] for kind, a, *_x in out if kind == "sse"],
            "json_replicas": [b["metadata"].get("replica_id") for kind, _a, b, _s in out
                              if kind == "json"]}


def record_verifies(rs) -> dict:
    """Wrap each replica service's ``generate`` (every JSON generate and
    every verify goes through it; a stream's answer does not) to keep, per
    replica, each greedy (verify) admission's prefix-hit tokens. Returns
    {replica: [hit tokens]}."""
    hits: dict = {i: [] for i in range(rs.replicas)}
    for i, svc in enumerate(rs.services):
        generate = svc.generate

        def recorded(prompt, _generate=generate, _i=i, **kwargs):
            result = _generate(prompt, **kwargs)
            if kwargs.get("temperature", 0.0) == 0.0:
                hits[_i].append(result.prefix_hit_tokens)
            return result

        svc.generate = recorded
    return hits


def replica_server(torch, dev, phase: str, weights, n_replicas: int, docs):
    """A pipeline under ``Settings()`` with ``REPLICAS=n_replicas`` and
    ``AFFINITY_STICKINESS=REPLICA_STICKINESS`` on ``weights``, warmed up
    (every replica at once) and ingested, behind ``create_server`` on
    127.0.0.1."""
    import gc
    import threading

    from sentio_tpu_torch.config import GeneratorConfig, ServeConfig, Settings
    from sentio_tpu_torch.pipeline import build_pipeline
    from sentio_tpu_torch.serve.app import create_server

    settings = Settings(generator=GeneratorConfig(max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS),
                        serve=ServeConfig(replicas=n_replicas,
                                          affinity_stickiness=REPLICA_STICKINESS))
    # earlier phases' pipelines may wait in reference cycles for the
    # collector: free their pools before two replicas need the room
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    pipeline = build_pipeline(settings, device=dev, seed=SEED, **(weights or {}))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    warm = pipeline.warmup()
    torch.cuda.synchronize()
    rs = pipeline.replica_set
    variants = len(rs.services[0].engine.graph_variants)
    per = warm["per_replica"]
    emit(f"{phase}_warmup", memory_allocated_before=memory0, build_s=build_s,
         seconds=warm["seconds"],
         replica_seconds=[r["seconds"] for r in per],
         captures=[r["graph_captures"] for r in per],
         capture_s=[r["graph_capture_s"] for r in per], prompts=warm["prompts"],
         head_tokens=warm["head_tokens"], peak_memory=torch.cuda.max_memory_allocated())
    if rs.replicas != n_replicas or any(r["graph_captures"] != variants for r in per) \
            or not all(svc.engine.graphs_frozen for svc in rs.services) \
            or min(warm["head_tokens"]) <= 0:
        raise AssertionError(f"{phase}: every replica must capture its {variants} graph "
                             f"variants and hold the template head: {warm}")
    pipeline.ingest(docs)
    server = create_server(settings, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name=f"smoke-{phase}", daemon=True)
    thread.start()
    return pipeline, server, thread, warm


def replica_burst(torch, phase: str, pipeline, client, words, offset: int) -> dict:
    """The burst of :func:`http_burst` in a counted window on a warmed
    replica set: no chat degraded, each replica served a chat, every
    verify admission a radix hit on its replica, each replica's decode
    sub-steps one paged launch per layer each (the bf16 kernel, counted by
    its wrapper and by the card), no capture, no tenant reservation left;
    reported: p50 / p95, each replica's chats and duty cycle."""
    rs = pipeline.replica_set
    rs.wait_idle()
    hits = record_verifies(rs)
    engines = [svc.engine for svc in rs.services]
    sub0 = [e.total_sub_steps for e in engines]
    cap0 = [e.graph_captures for e in engines]
    done0 = [svc.stats()["completed"] for svc in rs.services]
    routing0 = rs.stats()["routing"]
    for svc in rs.services:
        svc.reset_duty_cycle()
    window = LaunchWindow(torch)
    t0 = time.perf_counter()
    out = http_burst(client, words, REPLICA_JSON_CHATS, REPLICA_SSE_CHATS, offset)
    wall_s = time.perf_counter() - t0
    rs.wait_idle()
    launches, card = window.read()
    for svc in rs.services:
        del svc.generate  # the recording wrapper
    result = check_burst(phase, out)
    sub_steps = [e.total_sub_steps - s for e, s in zip(engines, sub0)]
    tenants = rs.tenants.stats()["per_tenant"]
    routing = rs.stats()["routing"]
    result.update(
        wall_s=wall_s, replicas=rs.replicas, decode_sub_steps=sub_steps,
        completed=[svc.stats()["completed"] - d for svc, d in zip(rs.services, done0)],
        duty_cycle=[svc.duty_cycle() for svc in rs.services],
        verify_prefix_hit_tokens=hits, launches=launches, device_launches=card,
        tenants={t: tenants[t] for t in ("a", "b")},
        routing={k: routing[k] - routing0[k] for k in routing},
        graph_captures_delta=[e.graph_captures - c for e, c in zip(engines, cap0)],
        peak_memory=torch.cuda.max_memory_allocated())
    emit(phase, offset=offset, **result)
    n_layers = engines[0].cfg.n_layers
    verifies = [h for per in hits.values() for h in per]
    if len(verifies) != REPLICA_JSON_CHATS + REPLICA_SSE_CHATS or min(verifies) <= 0:
        raise AssertionError(f"{phase}: every chat's verify admission must hit its replica's "
                             f"radix tree: {hits}")
    if any(result["graph_captures_delta"]) or min(result["completed"]) <= 0:
        raise AssertionError(f"{phase}: a capture under traffic, or a replica served no chat: "
                             f"{result}")
    if launches["paged_attention"] != n_layers * sum(sub_steps) or sum(sub_steps) <= 0 \
            or launches["paged_attention_quant"]:
        raise AssertionError(f"{phase}: decode launches are not one per layer per sub-step: "
                             f"{launches}, sub-steps {sub_steps}")
    if any(t["pending"] for t in result["tenants"].values()):
        raise AssertionError(f"{phase}: a tenant reservation was left pending: {tenants}")
    check_card(phase, card, launches)
    return result


def replica_rounds(torch, phase: str, pipeline, client, words) -> dict:
    """:func:`replica_burst` ``REPLICA_ROUNDS`` times, each on questions of
    its own (the same rounds at each replica count): each round's p50 and
    p95, the p50 and p95 of every chat of every round, and the launch
    counts of all rounds together."""
    total = REPLICA_JSON_CHATS + REPLICA_SSE_CHATS
    rounds = [replica_burst(torch, phase, pipeline, client, words, offset=3 * total * r)
              for r in range(REPLICA_ROUNDS)]
    seconds = [x for r in rounds for x in r["chat_s"]]

    def summed(key: str) -> dict:
        return {k: sum(r[key][k] for r in rounds) for k in rounds[0][key]}

    return {"rounds": rounds, "chat_s": seconds, "p50_s": percentile(seconds, 0.5),
            "p95_s": percentile(seconds, 0.95), "round_p50_s": [r["p50_s"] for r in rounds],
            "round_p95_s": [r["p95_s"] for r in rounds],
            "completed": [sum(c) for c in zip(*(r["completed"] for r in rounds))],
            "duty_cycle": [r["duty_cycle"] for r in rounds],
            "peak_memory": max(r["peak_memory"] for r in rounds),
            "launches": summed("launches"), "device_launches": summed("device_launches")}


def stop_server(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(timeout=10.0)


def replica_surfaces(phase: str, client, n_replicas: int) -> dict:
    """``/health`` healthy, a ``sentio_tpu_replica_stat`` row set per replica
    in ``/metrics``, ``/info`` naming the replicas."""
    status, health = replica_health(client)
    samples = parse_prometheus(client.request("GET", "/metrics")[2].decode())
    rows = sorted({dict(labels)["replica"] for (name, labels) in samples
                   if name == "sentio_tpu_replica_stat"})
    info = client.json("GET", "/info")[2]["generator"]["replicas"]
    detailed = client.json("GET", "/health/detailed")
    result = {"health": (status, health["status"]), "replica_stat_rows": rows, "info": info,
              "detailed": (detailed[0], detailed[2]["status"],
                           sorted(detailed[2]["components"]["breakers"]))}
    emit(f"{phase}_surfaces", **result)
    if (status, health["status"]) != (200, "healthy") or \
            rows != [str(i) for i in range(n_replicas)] or info["count"] != n_replicas:
        raise AssertionError(f"{phase}: /health, /metrics or /info: {result}")
    return result


def rebuild_window(recorder, replica: int, since_tick: int) -> dict:
    """Seconds from the replica's REBUILDING transition to its HEALTHY one
    on the flight recorder, after event ``since_tick``."""
    events = [e for e in recorder.events("replica_health")
              if e["tick"] > since_tick and e["replica"] == replica]
    t = {e["state_to"]: e["t_s"] for e in events}
    return {"states": [e["state_to"] for e in events],
            "rebuild_s": t.get("HEALTHY", 0.0) - t.get("REBUILDING", 0.0)}


def replica_rebuild_check(torch, pipeline, client, words) -> dict:
    """Replica 0's ticks fail until its breaker trips
    (``REPLICA_BREAKER_TICK_FAILURES``, 3): quarantine, then an in-place
    rebuild — the old engine's pool and graphs freed, a fresh engine on the
    same weights warmed up (every graph variant captured) — while chats keep
    coming over HTTP. Gates: every chat answered, those sent while replica 0
    was out of rotation by replica 1; ``/health`` degraded (200), then
    healthy with one rebuild; the fresh engine captured every variant while
    replica 1 served; every kernel's wrapper count equal to the card's over
    the whole phase. Reported: rebuild seconds, peak memory."""
    import threading

    from sentio_tpu_torch.infra import faults
    from sentio_tpu_torch.infra.flight import get_flight_recorder

    phase = "replica_rebuild"
    rs = pipeline.replica_set
    rs.wait_idle()
    recorder = get_flight_recorder()
    tick0 = recorder.record_tick(event="smoke_mark", phase=phase)
    old = rs.services[0]
    fail_replica_steps(old.engine, "smoke.replica0.step")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    memory0 = torch.cuda.memory_allocated()
    window = LaunchWindow(torch)
    faults.arm("smoke.replica0.step", faults.FaultRule(
        error=RuntimeError("replica 0 tick fails"), times=rs.breaker_tick_failures))
    failed = []
    # the failing ticks: work straight on replica 0 (each ticket ends with
    # an error result once its requeue is spent)
    while old.tick_failure_count < rs.breaker_tick_failures:
        failed.append(old.generate("a doomed tick on replica zero", max_new_tokens=4,
                                   timeout_s=60).finish_reason)
    faults.disarm("smoke.replica0.step")
    wait_for(lambda: rs.health_summary()["replicas"][0]["state"]
             in ("QUARANTINED", "REBUILDING"), 30, "the breaker to quarantine replica 0")
    t_quarantined = time.perf_counter()
    status = replica_health(client)
    chats, health_seen = [], {status[1]["status"]}
    stop = threading.Event()

    def traffic(k: int) -> None:
        i = 0
        while not stop.is_set():
            question = f"During the rebuild, what about {words[200 + 7 * k + i]}?"
            t0 = time.perf_counter()
            code, _, body = client.json("POST", "/chat", {"question": question})
            # out of rotation when the answer came back: so it was when the
            # chat was routed
            state = rs.health_summary()["replicas"][0]["state"]
            chats.append((state, code, body, time.perf_counter() - t0))
            i += 1

    threads = [threading.Thread(target=traffic, args=(k,), name=f"smoke-rebuild-{k}",
                                daemon=True) for k in range(2)]
    for t in threads:
        t.start()
    try:
        while rs.health_summary()["replicas"][0]["state"] != "HEALTHY":
            health_seen.add(replica_health(client)[1]["status"])
            time.sleep(0.5)
            if time.perf_counter() - t_quarantined > 300:
                raise AssertionError(f"{phase}: replica 0 not rebuilt within 300 s")
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=HTTP_TIMEOUT_S)
    rs.wait_idle()
    launches, card = window.read()
    fresh = rs.services[0]
    summary = rs.health_summary()
    timing = rebuild_window(recorder, 0, tick0)
    during = [c for c in chats if c[0] != "HEALTHY"]
    for i, (_state, code, body, _s) in enumerate(chats):
        check_http_chat(phase, i, code, body)
    result = {"failed_ticks": old.tick_failure_count, "failed_results": failed,
              "states": timing["states"], "rebuild_s": timing["rebuild_s"],
              "health_seen": sorted(health_seen), "status_after": summary["status"],
              "rebuilds": summary["replicas"][0]["rebuilds"], "chats": len(chats),
              "chats_during_rebuild": len(during),
              "chats_during_rebuild_replicas": sorted({c[2]["metadata"]["replica_id"]
                                                       for c in during}),
              "chat_s": [c[3] for c in chats], "old_pool_released": old.engine.pool is None,
              "fresh_captures": fresh.engine.graph_captures,
              "fresh_capture_s": fresh.engine.graph_capture_s,
              "memory_before": memory0, "memory_after": torch.cuda.memory_allocated(),
              "peak_memory": torch.cuda.max_memory_allocated(),
              "pump_leaked": rs.stats()["pump_leaked"], "launches": launches,
              "device_launches": card}
    emit(phase, **result)
    variants = len(fresh.engine.graph_variants)
    if fresh is old or result["rebuilds"] != 1 or summary["status"] != "healthy" \
            or "degraded" not in health_seen or not result["old_pool_released"]:
        raise AssertionError(f"{phase}: quarantine → rebuild → healthy did not happen: {result}")
    if fresh.engine.graph_captures != variants or not fresh.engine.graphs_frozen:
        raise AssertionError(f"{phase}: the fresh engine captured {fresh.engine.graph_captures} "
                             f"of {variants} graph variants")
    if not during or result["chats_during_rebuild_replicas"] != [1]:
        raise AssertionError(f"{phase}: chats during the rebuild must be answered by replica 1 "
                             f"while it served: {result}")
    check_card(phase, card, launches)
    return result


def replica_stall_check(torch, pipeline, client) -> dict:
    """Replica 0's pump wedges in a tick (a ``stall_event`` where
    ``paged.step`` is): with ``TICK_STALL_BUDGET_S`` 5 s (set on the live
    services for the phase: a sibling's tick can outlast 5 s while a
    rebuilt replica warms up beside it) the watchdog
    quarantines it with no exception seen, abandons its admitted request
    (a typed 503) and hands its queued requests to replica 1, which
    answers them; the wedged pump is counted leaked and keeps its pool, the
    replica is rebuilt beside it, and the event is then released. Gates:
    the queued requests answered by replica 1, the stall quarantine, one
    more rebuild, healthy after, launch counts equal to the card's.
    Reported: pump_leaked, rebuild seconds, peak memory."""
    import threading

    from sentio_tpu_torch.infra import faults
    from sentio_tpu_torch.infra.flight import get_flight_recorder

    phase = "replica_stall"
    rs = pipeline.replica_set
    rs.wait_idle()
    recorder = get_flight_recorder()
    tick0 = recorder.record_tick(event="smoke_mark", phase=phase)
    wedged = rs.services[0]
    fail_replica_steps(wedged.engine, "smoke.replica0.step")
    leaked0, rebuilds0 = rs.stats()["pump_leaked"], rs.health_summary()["replicas"][0]["rebuilds"]
    budget0 = wedged.tick_stall_budget_s
    for svc in rs.services:
        svc.tick_stall_budget_s = STALL_BUDGET_S
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    window = LaunchWindow(torch)
    release = threading.Event()
    rule = faults.FaultRule(stall_event=release, stall_s=600.0, times=1)
    faults.arm("smoke.replica0.step", rule)
    outcomes: dict = {}

    def submit(k: int) -> None:
        try:
            outcomes[k] = wedged.generate(f"queued behind a wedged pump {k}",
                                          max_new_tokens=8, timeout_s=300)
        except Exception as exc:  # noqa: BLE001 — the wedged ticket's typed error
            outcomes[k] = exc

    try:
        first = threading.Thread(target=submit, args=(0,), name="smoke-wedged", daemon=True)
        first.start()
        wait_for(lambda: rule.stalled == 1, 60, "replica 0's pump to wedge")
        pump = wedged._pump
        queued = [threading.Thread(target=submit, args=(k,), name=f"smoke-queued-{k}",
                                   daemon=True) for k in (1, 2, 3)]
        for t in queued:
            t.start()
        wait_for(lambda: len(wedged._inbox) >= 3, 30, "the queued requests in the inbox")
        t_stall = time.perf_counter()
        for t in [first, *queued]:
            t.join(timeout=120)
        detected_s = time.perf_counter() - t_stall
        wait_for(lambda: rs.health_summary()["replicas"][0]["rebuilds"] > rebuilds0
                 and rs.health_summary()["status"] == "healthy", 300,
                 "replica 0 to be rebuilt after the stall")
        leaked = rs.stats()["pump_leaked"] - leaked0
    finally:
        release.set()
        faults.disarm("smoke.replica0.step")
        for svc in rs.services:
            svc.tick_stall_budget_s = budget0
    pump.join(timeout=120)
    if pump.is_alive():
        raise AssertionError(f"{phase}: the wedged pump did not exit once released")
    rs.wait_idle()
    launches, card = window.read()
    stats = rs.stats()
    timing = rebuild_window(recorder, 0, tick0)
    answered = {k: v.replica_id for k, v in outcomes.items() if not isinstance(v, Exception)}
    result = {"stall_budget_s": STALL_BUDGET_S, "detected_and_handed_off_s": detected_s,
              "wedged_outcome": type(outcomes.get(0)).__name__,
              "queued_answered_by": answered, "stall_quarantines": stats["stall_quarantines"],
              "handed_off": stats["handed_off"], "pump_leaked": leaked,
              "states": timing["states"], "rebuild_s": timing["rebuild_s"],
              "wedged_pool_kept": wedged.engine.pool is not None,
              "peak_memory": torch.cuda.max_memory_allocated(), "launches": launches,
              "device_launches": card, "status_after": rs.health_summary()["status"],
              "health_after": replica_health(client)[0]}
    emit(phase, **result)
    if not isinstance(outcomes.get(0), Exception) or answered != {1: 1, 2: 1, 3: 1}:
        raise AssertionError(f"{phase}: the wedged request must fail typed and the queued ones "
                             f"be answered by replica 1: {outcomes}")
    if stats["stall_quarantines"] < 1 or leaked != 1 or "QUARANTINED" not in result["states"]:
        raise AssertionError(f"{phase}: no stall quarantine or no leaked pump: {result}")
    check_card(phase, card, launches)
    return result


def stream_resume_f32(torch, dev) -> dict:
    """A greedy stream whose replica dies after delivering tokens resumes
    on the survivor: float32 at Llama-3-8B width cut to 2 layers, plain
    decode attention (as ``chunked``), two engines behind a set; the
    delivered text must equal an uninterrupted greedy run's, with one
    resume and the tenant balanced."""
    import dataclasses

    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla
    from sentio_tpu_torch.runtime.replica import ReplicaSet
    from sentio_tpu_torch.runtime.service import PagedGenerationService

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(SEED + 5), dev)
    engines = [ContinuousBatchingEngine(model_config=cfg, params=params, max_slots=2,
                                        page_size=128, max_pages_per_seq=16,
                                        steps_per_tick=16, max_tick_steps=16, device=dev)
               for _ in range(2)]
    for e in engines:
        e.attn_impl = _paged_attn_xla
    rs = ReplicaSet([PagedGenerationService(e, default_timeout_s=300) for e in engines],
                    supervise=False, failover_budget=1)
    try:
        prompt = "resume drill: " + " ".join(f"word{i}" for i in range(60))
        result = resume_drill(torch, rs, prompt, RESUME_TOKENS, "f32")
    finally:
        rs.close()
        del rs, engines, params
        torch.cuda.empty_cache()
    if result["text_equal"] is not True:
        raise AssertionError(f"stream_resume: the resumed float32 text differs from the "
                             f"uninterrupted run: {result}")
    return result


def die_after_delivery(svc, point: str) -> None:
    """Hit fault ``point`` at the top of each tick of ``svc``'s engine once
    a stream of that service has delivered tokens: armed to fail once, the
    death lands on the first tick after the first delivered piece, however
    the pump and the caller interleave."""
    from sentio_tpu_torch.infra import faults

    step = svc.engine.step

    def step_after_delivery():
        if any(t.sent_tokens for t in list(svc._tickets.values())):
            faults.hit(point)
        return step()

    svc.engine.step = step_after_delivery


def resume_drill(torch, rs, prompt: str, n_tokens: int, tag: str, tenant: str = "resume"):
    """The uninterrupted greedy reference, then the same stream with the
    replica that serves it dying (its tick fails) on the first tick after
    its first delivered piece. Gates: one death, one resume, the tenant
    balanced (one admission per attempt, nothing pending); returns the
    texts' agreement."""
    from sentio_tpu_torch.infra import faults

    rs.wait_idle()
    reference = rs.generate(prompt, max_new_tokens=n_tokens, temperature=0.0, timeout_s=300)
    rs.wait_idle()
    stats0 = rs.stats()
    point = f"smoke.{tag}.step_after_delivery"
    for svc in rs.services:
        die_after_delivery(svc, point)
    rule = faults.FaultRule(error=RuntimeError("mid-stream replica death"), times=1)
    faults.arm(point, rule)
    try:
        pieces = list(rs.generate_stream(prompt, max_new_tokens=n_tokens, temperature=0.0,
                                         timeout_s=300, tenant=tenant))
    finally:
        faults.disarm(point)
        for svc in rs.services:
            del svc.engine.step  # the wrapper
    text = "".join(pieces)
    stats = rs.stats()
    tenant_stats = stats["tenants"]["per_tenant"][tenant]
    agree = 0
    for x, y in zip(text, reference.text):
        if x != y:
            break
        agree += 1
    result = {"tokens": n_tokens, "reference_tokens": len(reference.tokens),
              "pieces": len(pieces), "fired": rule.fired,
              "stream_resumes": stats["stream_resumes"] - stats0["stream_resumes"],
              "replayed_tokens": stats["resume_replayed_tokens"]
              - stats0["resume_replayed_tokens"],
              "tenant": {k: tenant_stats[k] for k in ("admitted", "pending")},
              "text_equal": text == reference.text, "agreeing_chars": agree,
              "chars": len(reference.text)}
    emit(f"stream_resume_{tag}", **result)
    if rule.fired != 1 or result["stream_resumes"] != 1 or tenant_stats["pending"] \
            or tenant_stats["admitted"] != 2:
        raise AssertionError(f"stream_resume_{tag}: expected one death, one resume and a "
                             f"balanced tenant: {result}")
    return result


# ------------------------------------------------------------ observability

OBS_JSON_CHATS = 4       # with OBS_SSE_CHATS, released together after the two lone chats
OBS_SSE_CHATS = 2
PROFILE_S = 3.0          # /debug/profile's window, opened while PROFILE_CHATS run
PROFILE_CHATS = 4
PROFILE_TOKENS = 256     # their answers: the window falls inside their decode
ESCAPE_TOKENS = 64       # the float32 escape-hatch chat
# the families JAX's collector registers whatever the settings, which the
# port's /metrics gained in this slice
NINE_FAMILIES = ("sentio_llm_tokens_total", "sentio_llm_latency_seconds",
                 "sentio_circuit_breaker_state", "sentio_tpu_hbm_bytes_in_use",
                 "sentio_tpu_batch_occupancy", "sentio_tpu_decode_tokens_per_second",
                 "sentio_tpu_ttft_seconds", "sentio_tpu_tpot_seconds",
                 "sentio_tpu_tick_duration_seconds")


def metric_sum(samples: dict, name: str) -> float:
    """The sum of a parsed /metrics sample over all its label sets."""
    return sum(v for (n, _labels), v in samples.items() if n == name)


def obs_chats(client, words, offset: int, n_json: int, n_sse: int, tag: str) -> list:
    """``n_json`` JSON and ``n_sse`` SSE chats released together, each
    under a ``thread_id`` of its own (its flight record's id); returns
    (kind, request id, answer check's result, seconds) for each."""
    import threading

    total = n_json + n_sse
    out: list = [None] * total
    start = threading.Barrier(total)

    def run(i: int) -> None:
        rid = f"obs-{tag}-{'json' if i < n_json else 'sse'}-{i}"
        question = (f"What ties {words[(offset + 3 * i) % len(words)]} to "
                    f"{words[(offset + 3 * i + 1) % len(words)]}?")
        start.wait(timeout=60)
        t0 = time.perf_counter()
        try:
            if i < n_json:
                status, _, body = client.json("POST", "/chat",
                                              {"question": question, "thread_id": rid})
                check_http_chat(f"observability {rid}", i, status, body)
                out[i] = ("json", rid, body["answer"], time.perf_counter() - t0)
            else:
                result = client.sse({"question": question, "thread_id": rid})
                out[i] = ("sse", rid, check_sse_chat(f"observability {rid}", i, result),
                          time.perf_counter() - t0)
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            out[i] = ("raised", rid, exc, time.perf_counter() - t0)

    threads = [threading.Thread(target=run, args=(i,), name=f"smoke-obs-{tag}-{i}",
                                daemon=True) for i in range(total)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"observability: a chat did not return within {HTTP_TIMEOUT_S} s")
    for kind, rid, payload, _s in out:
        if kind == "raised":
            raise AssertionError(f"observability chat {rid} raised: {payload!r}") from payload
    return out


def check_flight_record(client, rid: str, alone: bool) -> dict:
    """``/debug/flight/{rid}``: the engine section with the answer's and the
    verify's admissions on replica 0, a non-empty tick window whose ticks'
    phases sum to their pump_ms (within 0.01 ms), and decode tokens summed
    over the window equal to the tokens the two admissions folded (each
    token, and the EOS a "stop" folded unseen) when the chat ran alone, at
    least that beside other chats; its Chrome form parses with a tick
    slice and the request's span."""
    status, _, record = client.json("GET", f"/debug/flight/{rid}")
    if status != 200:
        raise AssertionError(f"observability: no flight record for {rid}: {status}")
    engine, ticks = record.get("engine") or {}, record.get("ticks") or []
    admissions = engine.get("admissions") or []
    folded = sum(a.get("tokens", 0) + (a.get("finish_reason") == "stop") for a in admissions)
    decoded = sum(t.get("decode_tokens", 0) for t in ticks)
    phase_err = max((abs(sum(t["phase_ms"].values()) - t["pump_ms"]) for t in ticks),
                    default=None)
    status_c, _, chrome = client.json("GET", f"/debug/flight/{rid}?format=chrome")
    names = [e["name"] for e in (chrome or {}).get("traceEvents", [])]
    out = {"admissions": len(admissions), "replica": engine.get("replica_id"),
           "ticks": len(ticks), "ticks_truncated": record.get("ticks_truncated", 0),
           "decode_tokens": decoded, "folded_tokens": folded,
           "ttft_ms": [a.get("ttft_ms") for a in admissions],
           "tpot_ms": [a.get("tpot_ms") for a in admissions],
           "max_phase_sum_err_ms": phase_err, "engine_window": record.get("engine_window"),
           "chrome_events": len(names),
           "chrome_tick_slices": sum(n.startswith("tick ") for n in names)}
    if len(admissions) != 2 or engine.get("replica_id") != 0 or not ticks \
            or record.get("engine_window") != "local":
        raise AssertionError(f"observability: {rid}'s engine section: {out}")
    if any("phase_ms" not in t or "pump_ms" not in t for t in ticks) or phase_err > 0.01:
        raise AssertionError(f"observability: {rid}'s ticks' phases do not sum to pump_ms: "
                             f"{out}")
    if (decoded != folded) if alone else (decoded < folded):
        raise AssertionError(f"observability: {rid}'s window decoded {decoded} tokens "
                             f"against its admissions' {folded}")
    if status_c != 200 or not out["chrome_tick_slices"] or f"request {rid}" not in names:
        raise AssertionError(f"observability: {rid}'s Chrome trace: {status_c}, {out}")
    return out


def profiled_chats(torch, pipeline, client, words, offset: int, tag: str) -> dict:
    """``/debug/profile?seconds=PROFILE_S`` while PROFILE_CHATS JSON chats
    run (a second call meanwhile must get 409): the Chrome trace it wrote,
    its launches of each hand-written device function beside the paged
    wrapper's tally over the same request, and its ``decode_tick#N``
    ranges (the pump's ``record_function``, opened on another thread than
    the profiler's)."""
    import collections
    import dataclasses
    import shutil
    import threading
    from pathlib import Path

    paged = wrappers()["paged_attention"]
    log_dir = tempfile.mkdtemp(prefix="smoke-profile-")
    out: dict = {}
    config = pipeline.generator.config
    pipeline.generator.config = dataclasses.replace(config, max_new_tokens=PROFILE_TOKENS)
    chats = threading.Thread(target=lambda: out.update(
        chats=obs_chats(client, words, offset, PROFILE_CHATS, 0, tag)), daemon=True)
    chats.start()
    decoded0 = pipeline.replica_set.services[0].engine.decode_tokens_total
    # the chats' prefills first: the window opens once they decode
    wait_for(lambda: pipeline.replica_set.services[0].engine.decode_tokens_total > decoded0,
             HTTP_TIMEOUT_S, "the profiled chats to decode")
    second: dict = {}

    def again() -> None:
        time.sleep(0.5)
        second["status"], _, second["body"] = client.json(
            "GET", f"/debug/profile?seconds=0.5&dir={log_dir}/second")

    other = threading.Thread(target=again, daemon=True)
    other.start()
    svc = pipeline.replica_set.services[0]
    tally0, ticks0 = paged.launches, svc.stats()["ticks"]
    t0 = time.perf_counter()
    status, _, body = client.json("GET", f"/debug/profile?seconds={PROFILE_S}&dir={log_dir}")
    request_s = time.perf_counter() - t0
    tally, pump_ticks = paged.launches - tally0, svc.stats()["ticks"] - ticks0
    other.join(timeout=HTTP_TIMEOUT_S)
    chats.join(timeout=HTTP_TIMEOUT_S)
    pipeline.generator.config = config
    try:
        files = sorted(Path(log_dir).glob("profile-*.json"))
        events = json.loads(files[0].read_text())["traceEvents"] if files else []
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    kernels = [e for e in events if e.get("cat") == "kernel"]

    def ranges(cat: str) -> int:
        return sum(e.get("cat") == cat and str(e.get("name", "")).startswith("decode_tick#")
                   for e in events)

    result = {"status": status, "body": body, "request_s": request_s,
              "second_status": second.get("status"), "trace_files": len(files),
              "kernel_events": len(kernels),
              "categories": dict(collections.Counter(str(e.get("cat")) for e in events)),
              "device_functions": {fn: sum(fn in e.get("name", "") for e in kernels)
                                   for fn in DEVICE_FUNCTIONS},
              "paged_wrapper_tally": tally, "pump_ticks": pump_ticks,
              # each range once on the pump thread's timeline, and once more
              # on the device's around the kernels it launched
              "decode_tick_ranges": ranges("user_annotation"),
              "decode_tick_device_ranges": ranges("gpu_user_annotation"),
              "chats": len(out.get("chats") or [])}
    if status != 200 or not body.get("started") or not files or second.get("status") != 409:
        raise AssertionError(f"observability: /debug/profile: {result}")
    if result["chats"] != PROFILE_CHATS:
        raise AssertionError(f"observability: the profiled chats did not all answer: {result}")
    return result


def observability_check(torch, pipeline, client, words) -> dict:
    """The pump's flight ticks, /metrics' TTFT / TPOT / tick families, the
    Chrome export and the profile window on a warmed one-replica server
    (``replicas_1``'s). In a counted window: a JSON chat and an SSE chat
    alone, then OBS_JSON_CHATS + OBS_SSE_CHATS at once. Gates: every chat
    answered; each chat's flight record (:func:`check_flight_record`); the
    TTFT count grew by the admissions (answer and verify a chat), the TPOT
    count by those with tokens after their first tick, the tick-duration
    count by the pump's ticks; the nine families present; the ticks' decode
    tokens equal to the engine's decode_tokens_total growth, no capture in
    a tick, the paged kernel once per layer per sub-step (the card's count
    the same). Then the server's first /debug/profile window, over
    PROFILE_CHATS chats of PROFILE_TOKENS, must write a trace naming the
    paged kernel's split and combine functions inside the graph replays
    and holding the pump's ``decode_tick#N`` ranges; a concurrent call
    409."""
    from sentio_tpu_torch.config import ObservabilityConfig
    from sentio_tpu_torch.infra import tracing
    from sentio_tpu_torch.infra.flight import get_flight_recorder

    phase = "observability"
    rs = pipeline.replica_set
    svc, engine = rs.services[0], rs.services[0].engine
    recorder = get_flight_recorder()
    rs.wait_idle()
    text0 = client.request("GET", "/metrics")[2].decode()
    m0 = parse_prometheus(text0)
    tick0 = recorder.record_tick(event="smoke_mark", phase=phase)
    ticks0, decode0, sub0 = svc.stats()["ticks"], engine.decode_tokens_total, \
        engine.total_sub_steps
    window = LaunchWindow(torch)
    t0 = time.perf_counter()
    lone = obs_chats(client, words, 300, 1, 0, "lone") + obs_chats(client, words, 303, 0, 1,
                                                                   "lone")
    burst = obs_chats(client, words, 310, OBS_JSON_CHATS, OBS_SSE_CHATS, "burst")
    wall_s = time.perf_counter() - t0
    rs.wait_idle()
    launches, card = window.read()
    text = client.request("GET", "/metrics")[2].decode()
    m1 = parse_prometheus(text)
    alone = {rid for _kind, rid, *_x in lone}
    records = {rid: check_flight_record(client, rid, alone=rid in alone)
               for _kind, rid, *_x in lone + burst}
    ticks = [e for e in recorder.timeline() if e["tick"] > tick0 and "event" not in e
             and e.get("replica") == 0]
    n_ticks = svc.stats()["ticks"] - ticks0
    admissions = 2 * len(records)
    with_tpot = sum(x is not None for r in records.values() for x in r["tpot_ms"])
    delta = {name: metric_sum(m1, name) - metric_sum(m0, name)
             for name in ("sentio_tpu_ttft_seconds_count", "sentio_tpu_tpot_seconds_count",
                          "sentio_tpu_tick_duration_seconds_count")}
    sub_steps = engine.total_sub_steps - sub0
    result = {"chats": len(records), "wall_s": wall_s,
              "chat_s": [s for *_x, s in lone + burst], "records": records,
              "admissions": admissions, "admissions_with_tpot": with_tpot,
              "metric_deltas": delta, "pump_ticks": n_ticks, "tick_events": len(ticks),
              "tick_decode_tokens": sum(t.get("decode_tokens", 0) for t in ticks),
              "engine_decode_tokens": engine.decode_tokens_total - decode0,
              "tick_graph_captures": sum(t.get("graph_captures", 0) for t in ticks),
              "tick_dur_ms_p50": percentile([t["dur_ms"] for t in ticks], 0.5) if ticks else None,
              "tick_pump_ms_p50": percentile([t["pump_ms"] for t in ticks], 0.5)
              if ticks else None,
              "decode_sub_steps": sub_steps, "launches": launches, "device_launches": card,
              "families_present": {name: f"# TYPE {name} " in text for name in NINE_FAMILIES}}
    if delta["sentio_tpu_ttft_seconds_count"] != admissions \
            or delta["sentio_tpu_tpot_seconds_count"] != with_tpot \
            or delta["sentio_tpu_tick_duration_seconds_count"] != n_ticks:
        emit(phase, **result)
        raise AssertionError(f"{phase}: /metrics' TTFT / TPOT / tick counts disagree with the "
                             f"admissions and ticks: {delta}, {admissions}, {with_tpot}, "
                             f"{n_ticks}")
    if not all(result["families_present"].values()) or len(ticks) != n_ticks \
            or result["tick_decode_tokens"] != result["engine_decode_tokens"] \
            or result["tick_graph_captures"]:
        emit(phase, **result)
        raise AssertionError(f"{phase}: the tick events disagree with the engine: {result}")
    if launches["paged_attention"] != engine.cfg.n_layers * sub_steps or sub_steps <= 0:
        emit(phase, **result)
        raise AssertionError(f"{phase}: decode launches are not one per layer per sub-step: "
                             f"{launches}, sub-steps {sub_steps}")
    check_card(phase, card, launches)
    # the pump's record_function ranges need tracing on; with no
    # OpenTelemetry SDK on the card's machine TRACING_ENABLED alone leaves
    # it off, so the window's check turns the ranges on by hand
    previous = tracing.get_tracing()
    ranges = tracing.TracingManager(ObservabilityConfig())
    ranges.enabled = True
    tracing.set_tracing(ranges)
    try:
        result["profile"] = profiled_chats(torch, pipeline, client, words, 340, "profile")
    finally:
        tracing.set_tracing(previous)
    emit(phase, **result)
    window = result["profile"]
    # create_server warmed the profiler: the server's first window opens at
    # once and records the card's kernels inside the graph replays and the
    # pump thread's ranges
    if not window["kernel_events"] or not window["device_functions"]["paged_decode_kernel"] \
            or not window["device_functions"]["paged_combine_kernel"]:
        raise AssertionError(f"{phase}: the first profile window's trace names no paged "
                             f"kernel: {window}")
    if not window["decode_tick_ranges"]:
        raise AssertionError(f"{phase}: the profile window holds no decode_tick#N range of "
                             f"the pump: {window}")
    return result


def escape_hatch_bf16(torch, pipeline) -> dict:
    """The paged path's escape hatch at full width and depth on
    ``replicas_1``'s pipeline (bf16, the flash prefill): with the failover
    budget at 0, replica 0's ticks fail (the answer's admission and its
    crash retry) and the provider answers from the contiguous engine.
    Gates: the fault fired twice, the contiguous engine prefilled, flash
    once per layer for it and no paged launch in the window (the card's
    counts the same). Reported: the seconds, peak memory over the pool,
    and how many characters agree with the uninterrupted paged answer
    before the first difference (bf16 prefill and decode round
    differently)."""
    from sentio_tpu_torch.infra import faults

    rs = pipeline.replica_set
    provider = pipeline.generator.provider
    engine, contiguous = rs.services[0].engine, provider.contiguous
    prompt = pipeline.generator.build_prompt("Where does the escape hatch lead?", [])
    rs.wait_idle()
    reference = provider.chat(prompt, max_new_tokens=MAX_TOKENS, temperature=0.0)
    rs.wait_idle()
    point = "smoke.escape.step"
    fail_replica_steps(engine, point)
    budget, rs.failover_budget = rs.failover_budget, 0
    rule = faults.FaultRule(error=RuntimeError("escape hatch drill"), times=2)
    torch.cuda.synchronize()
    memory0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    prefills0 = contiguous.prefills
    window = LaunchWindow(torch)
    faults.arm(point, rule)
    try:
        t0 = time.perf_counter()
        text = provider.chat(prompt, max_new_tokens=MAX_TOKENS, temperature=0.0)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        faults.disarm(point)
        rs.failover_budget = budget
        del engine.step  # the wrapper
    launches, card = window.read()
    agree = agreeing_prefix(list(text), list(reference))
    result = {"fired": rule.fired, "seconds": seconds,
              "contiguous_prefills": contiguous.prefills - prefills0,
              "memory_before": memory0, "peak_memory": torch.cuda.max_memory_allocated(),
              "peak_over_before": torch.cuda.max_memory_allocated() - memory0,
              "agreeing_chars": agree, "chars": len(reference), "text_equal": text == reference,
              "launches": launches, "device_launches": card}
    emit("escape_hatch_bf16", **result)
    if rule.fired != 2 or result["contiguous_prefills"] < 1 or not text \
            or launches["paged_attention"] \
            or launches["flash_attention"] != engine.cfg.n_layers * result["contiguous_prefills"]:
        raise AssertionError(f"escape_hatch_bf16: the chat must fall back to the contiguous "
                             f"engine: {result}")
    check_card("escape_hatch_bf16", card, launches)
    return result


def escape_hatch_f32(torch, dev) -> dict:
    """The escape hatch held to exact greedy text: float32 at Llama-3-8B
    width cut to 2 layers, plain attention on both engines (the kernels
    take bf16), one paged replica behind a set with no failover budget and
    the contiguous engine on the same weights behind the provider. The
    replica's ticks fail (the answer and its crash retry); the provider's
    answer must equal the uninterrupted paged answer. Reported: seconds
    and peak memory of the fallback chat."""
    import dataclasses

    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.infra import faults
    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.ops.generator import EngineProvider
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla
    from sentio_tpu_torch.runtime.replica import ReplicaSet
    from sentio_tpu_torch.runtime.service import PagedGenerationService

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=2, dtype="float32")
    params = init_llama(cfg, torch.Generator(device=dev).manual_seed(SEED + 7), dev)
    engine = ContinuousBatchingEngine(model_config=cfg, params=params, max_slots=2,
                                      page_size=128, max_pages_per_seq=16, steps_per_tick=16,
                                      max_tick_steps=16, device=dev)
    engine.attn_impl = _paged_attn_xla
    contiguous = GeneratorEngine(config=GeneratorConfig(dtype="float32"), model_config=cfg,
                                 params=params, device=dev)
    contiguous.attn_fn = None
    rs = ReplicaSet([PagedGenerationService(engine, default_timeout_s=300)], supervise=False,
                    failover_budget=0)
    provider = EngineProvider(contiguous=contiguous, service=rs)
    point = "smoke.escape_f32.step"
    prompt = "escape hatch drill: " + " ".join(f"word{i}" for i in range(60))
    try:
        reference = provider.chat(prompt, max_new_tokens=ESCAPE_TOKENS, temperature=0.0)
        rs.wait_idle()
        fail_replica_steps(engine, point)
        rule = faults.FaultRule(error=RuntimeError("escape hatch drill"), times=2)
        torch.cuda.synchronize()
        memory0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        faults.arm(point, rule)
        try:
            t0 = time.perf_counter()
            text = provider.chat(prompt, max_new_tokens=ESCAPE_TOKENS, temperature=0.0)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            faults.disarm(point)
        result = {"fired": rule.fired, "seconds": seconds, "prefills": contiguous.prefills,
                  "tick_failures": rs.services[0].stats()["tick_failures"],
                  "memory_before": memory0, "peak_memory": torch.cuda.max_memory_allocated(),
                  "text_equal": text == reference, "chars": len(reference)}
    finally:
        rs.close()
        del rs, engine, contiguous, provider, params
        torch.cuda.empty_cache()
    emit("escape_hatch_f32", **result)
    if result["fired"] != 2 or result["tick_failures"] != 2 or result["prefills"] != 1 \
            or result["text_equal"] is not True:
        raise AssertionError(f"escape_hatch_f32: the contiguous engine's answer must equal "
                             f"the uninterrupted paged one: {result}")
    return result


def cli_check(torch) -> dict:
    """``python -m sentio_tpu_torch info`` names the card, and ``trace`` (the
    default settings at full width, answers and verdicts of MAX_TOKENS)
    answers on it with its flight record's two admissions and writes a
    Chrome trace with tick slices. The tiny presets cannot run on the card:
    their head dims (16) are not among the kernels' tiles."""
    import os
    from pathlib import Path

    root = Path(__file__).resolve().parent
    env = dict(os.environ, LLM_MAX_TOKENS=str(MAX_TOKENS), VERIFIER_MAX_TOKENS=str(MAX_TOKENS))
    cmd = [sys.executable, "-m", "sentio_tpu_torch"]
    t0 = time.perf_counter()
    proc = subprocess.run([*cmd, "info"], cwd=root, env=env, capture_output=True, text=True,
                          timeout=300)
    info_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"cli info: exit {proc.returncode}: {proc.stderr[-2000:]}")
    info = json.loads(proc.stdout)
    with tempfile.TemporaryDirectory(prefix="smoke-trace-") as tmp:
        chrome_path = Path(tmp) / "trace.json"
        t0 = time.perf_counter()
        proc = subprocess.run([*cmd, "trace", "What does the paged cache hold?", "--chrome",
                               str(chrome_path)], cwd=root, env=env, capture_output=True,
                              text=True, timeout=600)
        trace_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli trace: exit {proc.returncode}: {proc.stderr[-3000:]}")
        trace = json.loads(proc.stdout)
        chrome = json.loads(chrome_path.read_text())
    flight = trace.get("flight") or {}
    names = [e["name"] for e in chrome.get("traceEvents", [])]
    result = {"info": info, "info_s": info_s, "trace_s": trace_s,
              "trace_keys": sorted(trace), "answer_chars": len(trace.get("answer") or ""),
              "admissions": len((flight.get("engine") or {}).get("admissions") or []),
              "flight_ticks": len(flight.get("ticks") or []),
              "chrome_events": len(names),
              "chrome_tick_slices": sum(n.startswith("tick ") for n in names)}
    emit("cli", **result)
    if info["devices"][0] != {"platform": "gpu", "kind": torch.cuda.get_device_name(0)} \
            or not result["answer_chars"] or result["admissions"] != 2 \
            or not result["flight_ticks"] or not result["chrome_tick_slices"]:
        raise AssertionError(f"cli: info or trace on the card: {result}")
    return result


def replica_phases(torch, dev, weights) -> dict:
    """replicas (REPLICAS=1 then 2 behind the HTTP server; observability and
    escape_hatch_bf16 on the one replica's server), replica_rebuild,
    replica_stall and stream_resume (float32, then bf16 at full depth on the
    two replicas), then escape_hatch_f32, on ``weights`` (random ones from
    the seed when None)."""
    docs, words = corpus(N_CHUNKS)
    out: dict = {}
    for n in (1, 2):
        phase = f"replicas_{n}"
        pipeline, server, thread, warm = replica_server(torch, dev, phase, weights, n, docs)
        try:
            client = HttpClient(server.server_address[1])
            out[phase] = {"warmup": warm, **replica_rounds(torch, phase, pipeline, client,
                                                           words)}
            out[f"{phase}_surfaces"] = replica_surfaces(phase, client, n)
            if n == 1:
                out["observability"] = observability_check(torch, pipeline, client, words)
                out["escape_hatch_bf16"] = escape_hatch_bf16(torch, pipeline)
            if n == 2:
                out["replica_rebuild"] = replica_rebuild_check(torch, pipeline, client, words)
                out["replica_stall"] = replica_stall_check(torch, pipeline, client)
                window = LaunchWindow(torch)
                bf16 = resume_drill(torch, pipeline.replica_set, docs[5].text[:400],
                                    RESUME_TOKENS_BF16, "bf16")
                bf16["launches"], bf16["device_launches"] = window.read()
                check_card("stream_resume_bf16", bf16["device_launches"], bf16["launches"])
                out["stream_resume_bf16"] = bf16
        finally:
            stop_server(server, thread)
            if weights is None:
                weights = shared_weights(pipeline)
            close_pipeline(torch, pipeline)
            del pipeline
    out["stream_resume_f32"] = stream_resume_f32(torch, dev)
    out["escape_hatch_f32"] = escape_hatch_f32(torch, dev)
    one, two = out["replicas_1"], out["replicas_2"]
    emit("replicas", p50_s=(one["p50_s"], two["p50_s"]), p95_s=(one["p95_s"], two["p95_s"]),
         round_p50_s=(one["round_p50_s"], two["round_p50_s"]),
         round_p95_s=(one["round_p95_s"], two["round_p95_s"]),
         round_p50_ratio=[b / a for a, b in zip(one["round_p50_s"], two["round_p50_s"])],
         warmup_s=(one["warmup"]["seconds"], two["warmup"]["seconds"]),
         peak_memory=(one["peak_memory"], two["peak_memory"]),
         duty_cycle=two["duty_cycle"], completed=two["completed"])
    return out


def replicas_1_rounds(torch, dev) -> dict:
    """replicas_1's warmup and rounds alone, on random weights: each
    round's p50 and each pump's duty cycle."""
    docs, words = corpus(N_CHUNKS)
    pipeline, server, thread, warm = replica_server(torch, dev, "replicas_1", None, 1, docs)
    try:
        out = replica_rounds(torch, "replicas_1", pipeline,
                             HttpClient(server.server_address[1]), words)
    finally:
        stop_server(server, thread)
        close_pipeline(torch, pipeline)
    emit("replicas_1_rounds", round_p50_s=out["round_p50_s"], p50_s=out["p50_s"],
         duty_cycle=out["duty_cycle"], warmup_s=warm["seconds"],
         sub_steps=[r["decode_sub_steps"] for r in out["rounds"]])
    return out


def new_phases(torch, dev, weights) -> dict:
    """train_encoder, train_encoder_wide, eval, quality_gates (the trained
    checkpoint in a temporary directory), then verify_modes on ``weights``
    (random ones from the seed when None)."""
    with tempfile.TemporaryDirectory(prefix="smoke-encoder-") as tmp:
        checkpoint = f"{tmp}/encoder"
        trained = train_encoder_check(torch, dev, checkpoint)
        del trained["params"]
        out = {"train_encoder": trained, "train_encoder_wide": train_encoder_wide_check(torch, dev),
               "eval": eval_check(torch, dev, checkpoint),
               "quality_gates": quality_gates_check(torch, dev, checkpoint)}
    out["verify_modes"] = verify_modes_check(torch, dev, weights)
    return out


def family_launches(card: dict, family: str) -> dict:
    """The card's counts (:func:`card_launches`) of one kernel's device
    functions."""
    return {fn: n for fn, n in card.items() if DEVICE_FUNCTIONS[fn][0] == family}


def device_launches(profile: dict, family: str) -> dict:
    """A profiled chat's launches of one kernel's device functions, as the
    card counted them and as the profiler recorded them, beside the
    wrapper's count and the chat's sub-steps."""
    return {"sub_steps": profile["decode_sub_steps"],
            "counted": profile["launches_counted"][family],
            **family_launches(profile["device_launches"], family),
            "profiler": family_launches(profile["profiler_launches"], family)}


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only-new", action="store_true",
                        help="build, the kernel checks, then only the replica tier's phases "
                             "(random 8B weights); ends without the result lines")
    parser.add_argument("--rounds-only", action="store_true",
                        help="build, then only replicas_1's warmup and rounds (random 8B "
                             "weights); ends without the result lines")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from sentio_tpu_torch import native
    from sentio_tpu_torch.config import GeneratorConfig, RetrievalConfig, Settings
    from sentio_tpu_torch.kernels import KERNELS
    from sentio_tpu_torch.kernels._build import build_all
    from sentio_tpu_torch.models.llama import init_llama

    # float32 comparisons below run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda)

    if args.rounds_only:
        build_all(KERNELS)
        replicas_1_rounds(torch, dev)
        return 0

    sweep, sweep_quant = span_sweep(), span_sweep(quant=True)
    seconds = build_all([*KERNELS, *(k for k in (*sweep.values(), *sweep_quant.values())
                                     if k not in KERNELS)])
    t0 = time.perf_counter()
    bm25_core = native.load_bm25() is not None
    tensor_core = {k.name: sass_counts(k) for k in KERNELS}
    emit("build", seconds=seconds, bm25_core_built=bm25_core,
         bm25_core_seconds=time.perf_counter() - t0, sass_tensor_core=tensor_core, ptxas={
             k.name: [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln
                      or "spill" in ln] for k in KERNELS})
    for name, op in (("flash_attention", "HGMMA"), ("paged_attention_quant", "HMMA")):
        if not tensor_core[name][op]:
            raise AssertionError(f"{name}'s products are not on the tensor cores: "
                                 f"{tensor_core[name]}")

    shape = "b8_h32_hkv8_d128_page128"
    paged = paged_check(torch, dev, sweep, f"decode_{shape}")
    paged_chat = paged_check(torch, dev, sweep, f"chat_decode_{shape}", CHAT_LENS)
    paged_quant = paged_check(torch, dev, sweep_quant, f"decode_int8_{shape}", quant=True)
    paged_quant_chat = paged_check(torch, dev, sweep_quant, f"chat_decode_int8_{shape}",
                                   CHAT_LENS, quant=True)
    eval_shape = "b8_h8_hkv4_d64_page16"
    paged_eval = paged_check(torch, dev, sweep, f"eval_decode_{eval_shape}", EVAL_LENS,
                             geometry=EVAL_GEOMETRY, scratch_idle=False)
    paged_quant_eval = paged_check(torch, dev, sweep_quant, f"eval_decode_int8_{eval_shape}",
                                   EVAL_LENS, quant=True, geometry=EVAL_GEOMETRY,
                                   scratch_idle=False)
    flash = flash_checks(torch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    if args.only_new:
        rep = replica_phases(torch, dev, None)
        rep["cli"] = cli_check(torch)
        emit("partial", phases=sorted(rep))
        return 0

    caps = dict(max_new_tokens=MAX_TOKENS, verifier_max_tokens=MAX_TOKENS)
    sl = run_slice(torch, dev, "slice", Settings(retrieval=RetrievalConfig(strategy="dense"),
                                                 generator=GeneratorConfig(**caps)))
    logits = logits_check(torch, dev, sl["pipeline"], sl["questions"][1])
    graph_check(torch, sl["pipeline"], sl["generate_prompt"])
    chunked_slice_check(torch, sl["pipeline"])
    profile = profile_chat(torch, sl["pipeline"], sl["questions"][2])

    # the default settings (hybrid retrieval, rrf) plus KV_QUANT=int8
    weights = shared_weights(sl["pipeline"])
    sl8 = run_slice(torch, dev, "slice_int8",
                    Settings(generator=GeneratorConfig(kv_quant="int8", **caps)),
                    shared=weights)
    check_int8_slice(sl8)
    logits8 = logits_check(torch, dev, sl8["pipeline"], sl["questions"][1], "logits_int8",
                           forced=logits["forced"])
    quantization_error(torch, logits, logits8)
    graph_check(torch, sl8["pipeline"], sl8["generate_prompt"], "graph_int8")
    chunked_slice_check(torch, sl8["pipeline"], "chunked_slice_int8")
    profile8 = profile_chat(torch, sl8["pipeline"], sl["questions"][2], "profile_int8")
    service = service_check(torch, sl8["pipeline"], sl8["words"])
    http = serve_http_check(torch, dev, weights)
    chunked_check(torch, dev, sl["generate_prompt"])

    # USE_PAGED_KV=0 with the default hybrid retrieval, on the same weights
    sc = run_contig_slice(torch, dev, Settings(generator=GeneratorConfig(
        use_paged_decode=False, **caps)), shared=weights)
    contig_logits_check(torch, sc["pipeline"], sc["generate_prompt"])
    contig_vs_paged_check(torch, dev, sl["generate_prompt"])

    # speculation: the earlier pipelines' pools go first; the weights stay
    freed = {name: close_pipeline(torch, x.pop("pipeline"))
             for name, x in (("slice", sl), ("slice_int8", sl8), ("slice_contig", sc))}
    emit("spec_memory", memory_allocated_after_close=freed)
    dcfg = bench_draft_config(weights["llama_config"])
    draft = {"draft_config": dcfg,
             "draft_params": init_llama(dcfg, torch.Generator(device=dev).manual_seed(SEED + 9),
                                        dev)}
    ss = run_spec_slice(torch, dev, Settings(generator=GeneratorConfig(speculative_k=SPEC_K,
                                                                       **caps)),
                        weights, draft)
    spec_service = service_check(torch, ss["pipeline"], ss["words"], "slice_spec_service",
                                 n_chats=4)
    profile_spec = profile_chat(torch, ss["pipeline"], ss["questions"][2], "profile_spec")
    close_pipeline(torch, ss.pop("pipeline"))
    spec_int8 = spec_int8_check(torch, dev, weights, draft)
    del draft
    spec_exact = spec_exact_check(torch, dev, [q[:63] for q in (*sl["questions"],
                                                                  sl["generate_prompt"])])
    new = new_phases(torch, dev, weights)
    ev, gates, vm = new["eval"]["counts"], new["quality_gates"]["launches"], new["verify_modes"]
    rep = replica_phases(torch, dev, weights)
    cli_check(torch)
    rep_paths = ("replicas_1", "replicas_2", "replica_rebuild", "replica_stall",
                 "stream_resume_bf16", "observability", "escape_hatch_bf16")

    main_flash = flash[0]  # the embedder's bidirectional shape
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/paged_attention.cu",
         "replaces": "sentio_tpu/kernels/paged_attention.py:58",
         "launches": sl["launches"]["paged_attention"],
         "launches_by_path": {"slice": sl["launches"]["paged_attention"],
                              "serve_http": http["chats"]["launches"]["paged_attention"],
                              "slice_spec": ss["launches"]["paged_attention"],
                              "slice_spec_service": spec_service["launches"]["paged_attention"],
                              "profile_spec": profile_spec["launches_counted"][
                                  "paged_attention"],
                              **{f"eval_{name}": ev[name]["launches"]["paged_attention"]
                                 for name in ("full_paged", "batched")},
                              "quality_gates_bf16": gates["bf16"]["launches"]["paged_attention"],
                              "quality_gates_gated":
                                  gates["gated"]["launches"]["paged_attention"],
                              "verify_modes": vm["launches"]["paged_attention"],
                              **{path: rep[path]["launches"]["paged_attention"]
                                 for path in rep_paths}},
         "device_launches_replica_tier": {path: family_launches(
             rep[path]["device_launches"], "paged_attention") for path in rep_paths},
         "device_launches_eval": {name: family_launches(ev[name]["device_launches"],
                                                        "paged_attention")
                                  for name in ("full_paged", "batched")},
         "device_launches_verify_modes": family_launches(vm["device_launches"],
                                                         "paged_attention"),
         "device_launches_slice_spec": family_launches(ss["device_launches"],
                                                       "paged_attention"),
         "device_launches": family_launches(sl["device_launches"], "paged_attention"),
         "device_launches_serve_http": family_launches(http["chats"]["device_launches"],
                                                       "paged_attention"),
         "device_launches_profiled_chat": device_launches(profile, "paged_attention"),
         **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
         "cases": [paged, paged_chat, paged_eval]},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/paged_attention_quant.cu",
         "replaces": "sentio_tpu/kernels/paged_attention.py:167",
         "launches": sl8["launches"]["paged_attention_quant"],
         "launches_by_path": {"slice_int8": sl8["launches"]["paged_attention_quant"],
                              "service": service["launches"]["paged_attention_quant"],
                              "slice_spec": ss["launches"]["paged_attention_quant"],
                              "spec_int8": spec_int8["launches"]["paged_attention_quant"],
                              "quality_gates_int8":
                                  gates["int8"]["launches"]["paged_attention_quant"]},
         "device_launches_quality_gates_int8": family_launches(
             gates["int8"]["device_launches"], "paged_attention_quant"),
         "device_launches": family_launches(sl8["device_launches"], "paged_attention_quant"),
         "device_launches_spec_int8": family_launches(spec_int8["device_launches"],
                                                      "paged_attention_quant"),
         "device_launches_profiled_chat": device_launches(profile8, "paged_attention_quant"),
         **{k: paged_quant[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
         "cases": [paged_quant, paged_quant_chat, paged_quant_eval]},
        {"name": "flash_attention", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/flash_attention.cu",
         "replaces": "sentio_tpu/kernels/flash_attention.py:41",
         "launches": sum(x["launches"]["flash_attention"] for x in (sl, sl8, sc)),
         "launches_by_path": {"slice": sl["launches"]["flash_attention"],
                              "slice_int8": sl8["launches"]["flash_attention"],
                              "slice_contig": sc["launches"]["flash_attention"],
                              "slice_contig_llm_prefills": sc["llm_flash_launches"],
                              "service": service["launches"]["flash_attention"],
                              "serve_http_ingest": http["ingest"]["launches"]["flash_attention"],
                              "serve_http": http["chats"]["launches"]["flash_attention"],
                              "slice_spec": ss["launches"]["flash_attention"],
                              "slice_spec_service": spec_service["launches"]["flash_attention"],
                              "spec_int8": spec_int8["launches"]["flash_attention"],
                              "spec_exact_contig_prefills":
                                  spec_exact["launches"]["flash_attention"],
                              "train_encoder_eval_recall":
                                  new["train_encoder"]["eval_recall_launches"]["flash_attention"],
                              **{f"eval_{name}": ev[name]["launches"]["flash_attention"]
                                 for name in ("dense", "hybrid_rerank", "full_paged",
                                              "batched")},
                              "verify_modes": vm["launches"]["flash_attention"],
                              **{path: rep[path]["launches"]["flash_attention"]
                                 for path in rep_paths}},
         "device_launches": {path: family_launches(x["device_launches"], "flash_attention")
                             for path, x in (("slice", sl), ("slice_int8", sl8),
                                             ("slice_contig", sc), ("service", service),
                                             ("serve_http_ingest", http["ingest"]),
                                             ("serve_http", http["chats"]), ("slice_spec", ss),
                                             ("slice_spec_service", spec_service),
                                             ("spec_int8", spec_int8),
                                             ("spec_exact", spec_exact), ("verify_modes", vm),
                                             *((path, rep[path]) for path in rep_paths))},
         "device_launches_eval": {name: family_launches(ev[name]["device_launches"],
                                                        "flash_attention")
                                  for name in ("dense", "hybrid_rerank", "full_paged",
                                               "batched")},
         "device_launches_profiled_chat": {
             path: device_launches(prof, "flash_attention")
             for path, prof in (("slice", profile), ("slice_int8", profile8),
                                ("slice_spec", profile_spec))},
         "max_abs_err": max(c["max_abs_err"] for c in flash),
         **{k: main_flash[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
         "cases": flash},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
