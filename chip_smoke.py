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
   cross-encoder's shapes and at ingest's full lengths.
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


def paged_problem(torch, dev, lens_list=SERVING_LENS):
    """The decode shape of the serving batch: B=8, H=32, Hkv=8, D=128, page
    128, NB 64, 513 pages of random bf16 K/V; rows at length 0 sit on
    scratch page 0, the others own 64 shuffled pages. Returns q, the pools,
    table, lens, the lengths as a list, and (page id, first unowned slot)
    for every owned page past a row's length (slot 0) and each current
    page's tail, the scratch page's included."""
    b, h, hkv, d, page, nb, num_pages = 8, 32, 8, 128, 128, 64, 513
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    kp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    table = torch.zeros((b, nb), dtype=torch.int32)
    perm = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(SEED)) + 1).tolist()
    unowned = [(0, 1)] if 0 in lens_list else []  # the scratch page past slot 0
    for row in range(b):
        if lens_list[row] == 0:
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
                quant: bool = False) -> dict:
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

    q, kp, vp, table, lens, lens_list, unowned = paged_problem(torch, dev, lens_list)
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
    case = {"case": name, "lens": lens_list, "max_abs_err": max_err,
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
                or warm["head_tokens"] <= 0):
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

    def sse(self, payload: dict, close_after_first_token: bool = False) -> dict:
        """One streamed /chat: the events in order, the seconds to the
        first ``token`` event and to the end."""
        import http.client

        t0 = time.perf_counter()
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=HTTP_TIMEOUT_S)
        conn.request("POST", "/chat", body=json.dumps({**payload, "stream": True}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        events, first_token_s = [], None
        try:
            while resp.status == 200:
                line = resp.fp.readline()
                if not line:
                    break
                line = line.decode().strip()
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
                    break
        finally:
            conn.close()
        return {"status": resp.status, "events": events, "first_token_s": first_token_s,
                "seconds": time.perf_counter() - t0}


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


def main() -> int:
    import torch

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
    flash = flash_checks(torch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

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
                                  "paged_attention"]},
         "device_launches_slice_spec": family_launches(ss["device_launches"],
                                                       "paged_attention"),
         "device_launches": family_launches(sl["device_launches"], "paged_attention"),
         "device_launches_serve_http": family_launches(http["chats"]["device_launches"],
                                                       "paged_attention"),
         "device_launches_profiled_chat": device_launches(profile, "paged_attention"),
         **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
         "cases": [paged, paged_chat]},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/paged_attention_quant.cu",
         "replaces": "sentio_tpu/kernels/paged_attention.py:167",
         "launches": sl8["launches"]["paged_attention_quant"],
         "launches_by_path": {"slice_int8": sl8["launches"]["paged_attention_quant"],
                              "service": service["launches"]["paged_attention_quant"],
                              "slice_spec": ss["launches"]["paged_attention_quant"],
                              "spec_int8": spec_int8["launches"]["paged_attention_quant"]},
         "device_launches": family_launches(sl8["device_launches"], "paged_attention_quant"),
         "device_launches_spec_int8": family_launches(spec_int8["device_launches"],
                                                      "paged_attention_quant"),
         "device_launches_profiled_chat": device_launches(profile8, "paged_attention_quant"),
         **{k: paged_quant[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
         "cases": [paged_quant, paged_quant_chat]},
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
                                  spec_exact["launches"]["flash_attention"]},
         "device_launches": {path: family_launches(x["device_launches"], "flash_attention")
                             for path, x in (("slice", sl), ("slice_int8", sl8),
                                             ("slice_contig", sc), ("service", service),
                                             ("serve_http_ingest", http["ingest"]),
                                             ("serve_http", http["chats"]), ("slice_spec", ss),
                                             ("slice_spec_service", spec_service),
                                             ("spec_int8", spec_int8),
                                             ("spec_exact", spec_exact))},
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
