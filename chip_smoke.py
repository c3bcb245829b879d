#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (sentio_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. Phases, one JSON
line each:

1. device — the card's name and power limit (nvidia-smi); no CUDA, no run.
2. build — both CUDA kernels built from csrc/ with nvcc, in parallel.
3. kernels — each kernel against its plain PyTorch version on the card at
   the shapes the main path gives it (bf16 kernel vs float32 plain: max abs
   error <= 2e-2 and mean <= 2e-3, since bf16 outputs carry ~3 significant
   digits and the sums run in another order), timed beside its plain
   version, the bound the card could reach, and one PyTorch call computing
   the same function (scaled_dot_product_attention, a yardstick only).
4. slice — the /chat pipeline at full width (Llama-3-8B, the base
   embedder, the default cross-encoder) with random weights made on the
   card from a seed: ingest 2,048 chunks, then answer 3 chats with every
   launch count set to 0 just before and read just after; both kernels
   must have run, and the paged kernel once per layer per decode sub-step.
5. logits — one prompt's prefill and 4 teacher-forced decode steps through
   the kernel path and the plain path.
6. profile — one more chat under the CUDA profiler: device time by kernel
   family and the device's idle share.

The last lines are the nvidia-smi line, one {"kernels": [...]} line, and
{"ok": true, "device": {...}}. Any failed check raises: the exit code is
then non-zero and no result line is printed.
"""

from __future__ import annotations

import json
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


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
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


def paged_check(torch, dev) -> dict:
    """Serving shapes: B=8, H=32, Hkv=8, D=128, page 128, NB 64, 513 pages;
    ragged lengths with a scratch row at length 0 on page 0 and partial
    last pages; NaN in every owned page past a row's length and in each
    current page's tail (the kernel must never read them)."""
    import torch.nn.functional as F

    from sentio_tpu_torch.kernels.paged_attention import paged_attention, paged_attention_plain

    b, h, hkv, d, page, nb, num_pages = 8, 32, 8, 128, 128, 64, 513
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    lens_list = [0, 5, 127, 128, 1000, 2047, 3000, 8191]
    kp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn((num_pages, page, hkv, d), generator=gen, device=dev, dtype=torch.bfloat16)
    table = torch.zeros((b, nb), dtype=torch.int32)
    perm = (torch.randperm(num_pages - 1, generator=torch.Generator().manual_seed(SEED)) + 1).tolist()
    for row in range(1, b):
        owned = [perm.pop() for _ in range(nb)]
        table[row] = torch.tensor(owned, dtype=torch.int32)
        used, tail = lens_list[row] // page + 1, lens_list[row] % page + 1
        kp[owned[used - 1], tail:] = float("nan")
        vp[owned[used - 1], tail:] = float("nan")
        for pid in owned[used:]:
            kp[pid] = float("nan")
            vp[pid] = float("nan")
    table = table.to(dev)
    lens = torch.tensor(lens_list, dtype=torch.int32, device=dev)
    q = torch.randn((b, h, d), generator=gen, device=dev, dtype=torch.bfloat16)

    out = paged_attention(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    ref = paged_attention_plain(q.float(), kp.float(), vp.float(), table, lens)
    max_err, mean_err = errors(out, ref)
    check_limits("paged_attention", max_err, mean_err)

    ms = time_ms(torch, lambda: paged_attention(q, kp, vp, table, lens))
    plain_ms = time_ms(torch, lambda: paged_attention_plain(q, kp, vp, table, lens), iters=5)
    # yardstick: SDPA over the rows' pages gathered densely beforehand
    window = nb * page
    valid = torch.arange(window, device=dev)[None, :] <= lens[:, None].long()
    dense_k = torch.where(valid[:, :, None, None],
                          kp[table.long()].reshape(b, window, hkv, d), 0).transpose(1, 2)
    dense_v = torch.where(valid[:, :, None, None],
                          vp[table.long()].reshape(b, window, hkv, d), 0).transpose(1, 2)
    dense_k = dense_k.repeat_interleave(h // hkv, dim=1)
    dense_v = dense_v.repeat_interleave(h // hkv, dim=1)
    mask = valid[:, None, None, :]
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], dense_k, dense_v, attn_mask=mask))
    keys = sum(n + 1 for n in lens_list)
    n_bytes = keys * hkv * d * 2 * 2 + 2 * q.numel() * 2 + table.numel() * 4 + b * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * h * d * keys)
    case = {"case": "decode_b8_h32_hkv8_d128_page128", "max_abs_err": max_err,
            "mean_abs_err": mean_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": library_ms}
    emit("kernel", name="paged_attention", **case)
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

    ms = time_ms(torch, lambda: flash_attention(q, k, v, lens, causal=causal))
    plain_ms = time_ms(torch, lambda: flash_attention_plain(q, k, v, lens, causal=causal),
                       iters=5)
    pos = torch.arange(t, device=dev)
    mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
    if causal:
        mask = mask & (pos[None, :] <= pos[:, None])[None, None]
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                       attn_mask=mask))
    # operations this data needs: the attendable (query, key) pairs only
    pairs = sum(min(q_pos + 1, n) if causal else n for n in lens_list for q_pos in range(t))
    n_bytes = 4 * q.numel() * 2 + b * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * h * d * pairs)
    case = {"case": name, "max_abs_err": max_err, "mean_abs_err": mean_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms}
    emit("kernel", name="flash_attention", **case)
    return case


def flash_checks(torch, dev) -> list[dict]:
    """The embedder's ingest batch (B=128, T=512, H=16, D=64) and the tiny
    cross-encoder's rerank batch (B=32, T=128, H=2, D=32), bidirectional as
    the main path runs them and causal, with ragged and zero lengths."""
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
    return cases


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


def run_slice(torch, dev) -> dict:
    from sentio_tpu_torch.config import GeneratorConfig, RetrievalConfig, Settings
    from sentio_tpu_torch.kernels import FLASH_KERNEL, PAGED_KERNEL
    from sentio_tpu_torch.pipeline import build_pipeline

    settings = Settings(
        retrieval=RetrievalConfig(strategy="dense"),
        generator=GeneratorConfig(max_new_tokens=MAX_TOKENS, verifier_max_tokens=MAX_TOKENS),
    )
    t0 = time.perf_counter()
    pipeline = build_pipeline(settings, device=dev, seed=SEED)
    torch.cuda.synchronize()
    engine = pipeline.generator.provider.engine
    emit("slice_build", seconds=time.perf_counter() - t0,
         llama=engine.cfg.__dict__, embedder=pipeline.embedder.model_config.__dict__,
         cross_encoder=pipeline.reranker.model_config.__dict__,
         pool_bytes=engine.pool.hbm_bytes, memory_allocated=torch.cuda.memory_allocated())

    docs, words = corpus(N_CHUNKS)
    t0 = time.perf_counter()
    pipeline.ingest(docs)
    torch.cuda.synchronize()
    emit("ingest", chunks=len(docs), seconds=time.perf_counter() - t0,
         index_size=pipeline.index.size)

    questions = [docs[17].text,
                 f"What does the corpus say about {words[3]} and {words[40]}?",
                 f"Summarize the passages that mention {words[100]}."]
    PAGED_KERNEL.launches = 0
    FLASH_KERNEL.launches = 0
    sub_steps0 = engine.total_sub_steps
    chats = []
    t_all = time.perf_counter()
    for question in questions:
        t0 = time.perf_counter()
        response = pipeline.chat(question)
        torch.cuda.synchronize()
        chats.append((response, time.perf_counter() - t0))
    total_s = time.perf_counter() - t_all
    launches = {"paged_attention": PAGED_KERNEL.launches,
                "flash_attention": FLASH_KERNEL.launches}
    sub_steps = engine.total_sub_steps - sub_steps0

    for i, (response, seconds) in enumerate(chats):
        meta = response["metadata"]
        emit("chat", index=i, seconds=seconds, stage_ms=meta["stage_ms"],
             generated_tokens=meta["generated_tokens"], answer_chars=len(response["answer"]),
             verdict=response["verification"].get("verdict"),
             sources=[s["id"] for s in response["sources"]])
        if not response["answer"]:
            raise AssertionError(f"chat {i} returned an empty answer")
        notes = response["verification"].get("notes", [])
        if any(str(n).startswith("verifier error") for n in notes):
            raise AssertionError(f"chat {i}: verification failed: {notes}")
    if chats[0][0]["metadata"]["retrieved_ids"][0] != docs[17].id:
        raise AssertionError("a chunk's own text did not retrieve that chunk first")
    n_layers = engine.cfg.n_layers
    emit("slice", chats=len(chats), seconds=total_s, decode_sub_steps=sub_steps,
         launches=launches, expected_paged_launches=n_layers * sub_steps,
         peak_memory=torch.cuda.max_memory_allocated())
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if launches["paged_attention"] != n_layers * sub_steps:
        raise AssertionError("a decode sub-step bypassed the paged kernel")
    return {"pipeline": pipeline, "launches": launches, "questions": questions}


def logits_check(torch, dev, pipeline, question: str) -> dict:
    """Prefill + 4 teacher-forced decode steps of the generate prompt through
    the kernel path and the plain path; the forced tokens are the kernel
    path's greedy picks, fed to both."""
    import numpy as np

    from sentio_tpu_torch.kernels import paged_attn_impl
    from sentio_tpu_torch.runtime.paged import _paged_attn_xla

    engine = pipeline.generator.provider.engine
    docs = pipeline.index.documents()[:5]
    prompt = pipeline.generator.build_prompt(question, docs)
    window = engine.max_pages_per_seq * engine.page_size
    ids = engine.tokenizer.encode(prompt, add_bos=True)[: window - 8]
    width = engine._prefill_width(len(ids))
    n_pages = width // engine.page_size
    pages = engine.allocator.alloc(n_pages)
    row = torch.zeros((1, engine.max_pages_per_seq), dtype=torch.int32)
    row[0, :n_pages] = torch.tensor(pages, dtype=torch.int32)
    table = row.to(dev)
    id_arr = np.full((1, width), engine.tokenizer.pad_id, np.int64)
    id_arr[0, : len(ids)] = ids
    runs, forced = [], []
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
    emit("logits", **result)
    if not bool(torch.isfinite(runs[0]).all()) or max(diff) > LOGITS_LIMIT:
        raise AssertionError(f"kernel vs plain logits differ by {max(diff)} > {LOGITS_LIMIT}")
    return result


def profile_chat(torch, pipeline, question: str) -> dict:
    """One more chat (after the counted window) under the CUDA profiler:
    device time by kernel family and the device's idle share of the wall
    time. Tracing adds host overhead, so the idle share is an upper bound."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipeline.chat(question)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [(e.key, e.self_device_time_total / 1e3, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(ms for _, ms, _ in kernels)
    families = {"paged_decode_kernel": 0.0, "flash_fwd_kernel": 0.0, "matmul": 0.0,
                "other": 0.0}
    for name, ms, _ in kernels:
        family = next((f for f in ("paged_decode_kernel", "flash_fwd_kernel") if f in name),
                      None)
        if family is None:  # cuBLAS names its products gemm / nvjet / xmma kernels
            matmul = any(tag in name.lower() for tag in ("gemm", "nvjet", "xmma", "cutlass"))
            family = "matmul" if matmul else "other"
        families[family] += ms
    top = sorted(kernels, key=lambda k: -k[1])[:8]
    result = {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
              "idle_share": (1 - busy_ms / wall_ms) if busy_ms else None,
              "device_ms_by_family": families,
              "top_kernels": [{"name": n[:90], "ms": ms, "count": c} for n, ms, c in top]}
    emit("profile", **result)
    return result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from sentio_tpu_torch.kernels import KERNELS
    from sentio_tpu_torch.kernels._build import build_all

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

    seconds = build_all(KERNELS)
    emit("build", seconds=seconds, ptxas={
        k.name: [ln.strip() for ln in k.build_log.splitlines() if "registers" in ln
                 or "spill" in ln] for k in KERNELS})

    paged = paged_check(torch, dev)
    flash = flash_checks(torch, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    sl = run_slice(torch, dev)
    logits_check(torch, dev, sl["pipeline"], sl["questions"][1])
    profile_chat(torch, sl["pipeline"], sl["questions"][2])

    main_flash = flash[0]  # the embedder's bidirectional shape
    kernels = [
        {"name": "paged_attention", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/paged_attention.cu",
         "replaces": "sentio_tpu/kernels/paged_attention.py:58",
         "launches": sl["launches"]["paged_attention"],
         **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
         "cases": [paged]},
        {"name": "flash_attention", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/flash_attention.cu",
         "replaces": "sentio_tpu/kernels/flash_attention.py:41",
         "launches": sl["launches"]["flash_attention"],
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
