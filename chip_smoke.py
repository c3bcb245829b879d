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

13. slice_spec — speculative decoding at full width, the target cut to
    4 of Llama-3-8B's 32 layers (``SPEC_LAYERS``, to keep the run inside
    its time limit since convert_serve): a pipeline
    under the default settings (hybrid rrf, bf16 pool, prefix cache, depth
    2) with bench.py phase E's draft (dim 2048, 4 layers, 16 / 4 heads, MLP
    7,168, random from the seed) passed to ``build_pipeline``, k 4, on the
    slices' Llama-3-8B tensors (views of the first 4 layers; the earlier
    pipelines' pools freed first).
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
    1,024; 12 of its 24 layers since convert_serve, ``WIDE_LAYERS``) in bf16
    compute (step ms, peak memory) and in
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
    full width, Llama-3-8B cut to ``TIER_LAYERS`` (8) of its 32 layers, as
    are the worker phases (28–31) and elastic (36) on the same tensors
    (``Settings()`` with REPLICAS=1, then 2): warmup of every
    replica at once (seconds, each
    replica's captures), then ``REPLICA_ROUNDS`` (2) rounds of 8 JSON and 2
    SSE chats at once
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
    uninterrupted run's; in bf16 at the tier's depth on the two replicas through
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

28. replicas_2_process — REPLICA_MODE=process, REPLICAS=2 behind the HTTP
    server at full width, with replicas_2's settings and traffic: two
    worker processes, each with its own engine, pool, radix tree, CUDA
    graphs and pump, on the router's weight tensors (passed to each spawn
    as CUDA IPC handles). Each spawn is metered: the card's used memory
    (``torch.cuda.mem_get_info``, every process's) before and after it,
    beside the worker's own allocator. Gates: each worker's rise at spawn
    less its reserved bytes at most 2 GB (its CUDA context), its reserved
    bytes below the weights' (a private copy would show in one or the
    other); every worker captured every graph variant and holds the head;
    in its round (one; ``--worker-rounds`` runs three in each mode) no
    chat degraded, each worker served a chat, every
    verify a radix hit, each worker's paged launches one per layer per
    sub-step and equal to its own card counts (read in its process, through
    its ``stats``), the router's flash launches equal to the card's and no
    paged launch in the router; a lone greedy request's text equal to
    thread mode's; /info and /health/detailed name both workers. Reported:
    round p50 / p95 beside thread-mode replicas_2's from the same run,
    each worker's duty cycle, chats and memory, the card's used bytes.
29. worker_kill — on that server: worker 0 SIGKILLed once it holds work in
    a burst (no caller fails: its unanswered tickets are handed to the
    survivor, its delivered streams resume there; respawned, healthy, one
    death in /metrics), then a 128-token greedy stream whose worker
    SIGKILLs itself after the first delivered piece (``kill_process`` at
    the worker's stream-chunk fault point) resumes on the survivor with
    the uninterrupted run's text. Reported: seconds to respawn.
30. replicas_2_socket — REPLICA_MODE=socket, the spawned workers
    registering with the router's WorkerRegistry on 127.0.0.1: one round
    (gated as 28), the lone greedy text, then the half-open partition: once
    a stream delivered its first piece the router's reads from its worker
    stall at the recv frame point (``faults.hit_frame``) while its writes
    land. Gates: detected within SOCKET_PARTITION_TIMEOUT_S plus one status
    interval and one supervisor pass, the stream's text equal to the
    uninterrupted run's, the worker healed (the same pid) at a higher
    epoch, its old-epoch frames counted stale.
31. remote_worker — ``worker_serve`` started as its own process with its
    own weights made from the seed, a router dialing it
    (REPLICA_WORKERS=127.0.0.1:<port>, a shared SOCKET_AUTH_TOKEN): the lone
    greedy text equal to thread mode's, its launches equal to its card's.

The MoE phases (32–34) run right after the kernel checks, before phase 4:
their 47 GB of weights cannot sit beside Llama-3-8B's, whose tensors the
later phases keep to the end (a SIGKILLed worker never releases its CUDA
IPC handles on them).

32. slice_moe — the /chat pipeline at Mixtral-8x7B's published widths
    (dim 4,096, MLP 14,336, 32 / 8 heads, 8 experts, top-2, vocab 32,000,
    rope 1e6; the no-drop capacity factor 4.0) cut to 8 of its 32 layers
    (``MOE_LAYERS``; ~23.7 GB of bf16 weights made on the card from the
    seed), under
    ``Settings()`` (hybrid rrf, bf16
    pool, prefix cache, one replica, sync verify): warmup, ingest, 3 chats
    in a counted window, gated as phase 4, plus the routing of the window
    (choices routed to each expert, every expert used, none dropped);
    ``moe_logits`` (phase 5 on its engine), ``moe_sub_step`` (the captured
    greedy sub-step replayed, device ms beside the bound of reading every
    weight once), ``moe_prefill_routes`` (chat 1's generate and verify
    prefills again through each expert dispatch: grouped rows and capacity
    buffers, device ms) and ``profile_moe`` (phase 8) on its pipeline.
33. slice_moe_int8 — the same weights under KV_QUANT=int8: one chat, the
    int8 kernel once per layer per sub-step.
34. moe_exact — bench.py's moe geometry (dim 1,024, 12 layers, 8 experts,
    top-2; 1.31 B parameters) in float32 at cf 4.0 with plain attention:
    greedy tokens equal from graph replays and eagerly, on the contiguous
    engine, under paged speculation (2-layer llama draft) and contiguous
    speculation (2-layer MoE draft), through a thread-mode replica's
    service and one REPLICA_MODE=process worker; meanwhile the geometry
    in bf16, written first as a ``"family": "moe"`` checkpoint, answers
    ``python -m sentio_tpu_torch chat`` under LLM_CHECKPOINT in a process
    of its own.

35. serve_settings (after serve_http) — the last settings a one-card
    deployment can set, all at once, behind ``create_server`` on 127.0.0.1
    at full width on the slices' weights: AUTH_ENABLED=1 with two users,
    CACHE_BACKEND=multi_tier against a fake Redis on loopback, USE_SCORERS=1,
    WEB_CACHE_PATH (64 chunks in words the corpus never uses, embedded with
    the server's weights, saved by the port and loaded by the server),
    INDEX_BACKEND=qdrant against a fake Qdrant on loopback (standard
    library and numpy) holding the 2,048 ingested chunks, and
    METRICS_ENABLED=0. Gates: a chat with no token or a bad one is JAX's
    401 and launches nothing; /, /health and /metrics answer without one;
    each user's chats (distinct questions, sent with a spoofed X-Tenant)
    are answered and charged to ``user:<name>`` in the tenant ledger; in
    the counted window the bf16 paged kernel ran once per layer per
    sub-step and the flash kernel as often as the embedder's and the
    cross-encoder's forwards predict (one layer each a forward; the last
    chat runs with the embedding cache emptied, so the scorers embed the
    whole candidate pool at its chunk lengths), every count equal to the
    card's, every chat's stages with the scorers' own ms; a repeated
    question leaves its answer in the L1 query cache and its embeddings in
    the embedder's cache (JAX's /chat reads the query cache only on its
    degradation ladder, so a repeat runs the pipeline again); a value
    written through the tiered set is in the fake Redis and, dropped from
    L1, reads back and is promoted; the web cache's chunk is the first hit
    for a question it answers; /metrics still counts the chats; then the
    fake Qdrant stops: every chat is answered from BM25 and the cache leg,
    its flight record naming the dropped dense leg, the store's breaker
    opens after its 5th failure (the next chat fails fast) and
    /health/detailed lists it open beside replica 0.

36. elastic (after remote_worker, on the tier's weights) — the elastic
    fleet at full width: REPLICA_MODE=socket, REPLICAS=1, AUTOSCALE=1 with
    AUTOSCALE_MAX_REPLICAS=2 behind ``create_server`` on 127.0.0.1, its
    windows, cooldowns and poll short (``ELASTIC_SERVE``, printed with the
    phase), ADMISSION_MAX_QUEUE 32, AFFINITY_STICKINESS 0. The live
    autoscaler thread alone decides (the phase never calls ``step`` or
    ``retire``): (1) a burst of concurrent chats grows the fleet (its
    backlog fraction over the window); the launched worker spawns on the
    router's weight tensors, registers with slot -1 and is warmed before it
    joins; (2) a second wave reaches the joined worker, whose
    ``/debug/flight`` is ``stitched`` and whose lone greedy text equals
    thread mode's; (3) its ``request_leave`` is answered by a graceful
    retire: the slot released, a redial of it rejected typed; (4) another
    burst makes the autoscaler launch again, the new worker reusing the
    slot at epoch 2; (5) with a stream in flight on each replica (the phase
    routes each), the idle fleet retires one as its scale-in cooldown ends:
    a scale-in that follows the phase's re-base of every worker's duty
    (``reset_duty_cycle`` at the second join; the cumulative duty before
    it is reported); the stream on it finishes inside the drain with the
    text of an uninterrupted greedy run; (6) the CLI's fleet trace has a
    lane for each incarnation, the retired ones marked. Gates: every chat
    200 and not degraded; /metrics' decisions out >= 2 and in >= 1 and
    sentio_tpu_fleet_live_replicas 1, 2, 1, 2, 1 at the steps; each worker's
    paged launches one per layer per sub-step and equal to its card counts,
    the router's flash launches equal to the router's; at each join the
    card's used bytes rise by at most the worker's reserved bytes plus
    2 GB and that reserve is below the weights' bytes, and after each
    retire they fall back to within 1 GB of the level before the join.
    Reported: the seconds from each decision to the first
    chat the joined worker served, retire_drain_p95_s, tickets handed off,
    each worker's duty cycle, the phase's wall time.

37. convert_serve (after cli, the earlier pipelines' pools freed) — real
    checkpoints' path on the slices' weights: Hugging Face directories
    written from the card's tensors with the standard library and numpy
    (safetensors, HF names, ``[out, in]``): Llama-3-8B's full width cut to
    ``CONVERT_LAYERS`` (2) of its 32 layers as ``llama``, the base embedder
    at its 24 layers as ``xlm-roberta`` (two offset rows before its position
    table), the default cross-encoder as ``bert`` with the head its tree
    maps to; their tokenizers written with ``json``: a byte-level BPE with
    Llama-3's pre-tokenizer filling the model's 128,256 ids (128,000
    synthetic BPE tokens, every pair of byte symbols then pair + symbol,
    and Llama-3's 256 specials; bos ``<|begin_of_text|>``, eos
    ``<|end_of_text|>``, no pad), XLM-R's real layout for the embedder
    (``Sequence[Precompiled, Replace(" {2,}" → " ")]``, ``Metaspace``, a
    ``Unigram`` with XLM-R's specials at 0–3; the precompiled character
    map built here, first fit, from ``NFKC`` of every code point, ``Nmt``'s
    controls and spaces and a few multi-code-point cluster keys; its bytes
    and build seconds reported), a BERT ``WordPiece`` of 512 entries.
    ``python -m sentio_tpu_torch convert`` runs for the three families at
    once, each in a process of its own (seconds and bytes reported), then
    ``build_pipeline(Settings.from_env())`` reads LLM_CHECKPOINT /
    LLM_TOKENIZER, EMBEDDER_CHECKPOINT / EMBEDDER_TOKENIZER and
    RERANKER_CHECKPOINT / RERANKER_TOKENIZER. Gates: every converted leaf,
    loaded on the card, bit-equal to its source tensor, each config equal
    to the live one; every component on its checkpoint's tokenizer (the
    router's too); the embedder's tokenizer maps "ﬁne  cafe\u0301 ①" to
    the ids of "fine café 1" (the map's NFKC and cluster key, then the
    Replace); the generator's tokenizer round-trips the chats'
    questions and prompts; the ingest's seconds in the embedder
    tokenizer's ``encode`` reported; 3 chats on 512 chunks in a counted window
    answered, the bf16 paged kernel once per layer (2) per decode sub-step,
    flash as often as the embedder's and cross-encoder's forwards predict,
    each count equal to the card's, no capture after warmup; one prompt's
    greedy tokens from an engine on the converted weights equal an engine's
    on the in-memory tensors (cut to 2 layers) with the same tokenizer
    object, its text that tokenizer's decode of them. Reported: the verify
    admissions' radix hits (a byte-level BPE merges across the template
    head's boundary, as JAX's does). Then provider_settings: EMBEDDER_PROVIDER=
    hash, RERANKER_KIND=passthrough and LLM_PROVIDER=openai against the
    port's MockModelServer on 127.0.0.1: the build adds nothing to the
    card's allocated memory, and two chats are answered with no launch of
    any kernel, the card's counts zero.

38. mesh_tp (after the single-card slices' pools are freed, on their
    weights) — the serving mesh at tp=2 laid over two coordinates of the
    one card (``build_mesh(MeshConfig(dp_size=1, tp_size=2),
    devices=[cuda:0, cuda:0])``): Llama-3-8B at full width and 32 layers
    sharded by ``LLAMA_TP_RULES`` (the column-sharded weights are views of
    the source tensors, the row-sharded ``wo`` and ``w_down`` halves
    copies), the base embedder and the default cross-encoder by
    ``ENCODER_TP_RULES``, the index's rows over both coordinates; warmup,
    2,048 chunks, 3 chats in a counted window under the default settings.
    Gates: the bf16 paged kernel once per layer per shard per decode
    sub-step (2 × 32 × sub-steps, through the graph replays, each graph
    covering both shards), flash once per layer per shard per encoder
    forward (2 × (24 × embedder forwards + 2 × rerank forwards)), each
    count equal to the card's, no capture after warmup, every verify a
    radix hit. Then one prompt's prefill and 4 teacher-forced decode steps
    on a tp=2 engine and on a tp=1 engine on the same weights cut to
    ``MESH_PARITY_LAYERS`` (4) layers: every logit row within the logits
    phase's 0.25, greedy agreement reported, 2 × 4 × 4 paged launches (=
    the card's); the same with KV_QUANT=int8 through the int8 kernel per
    shard;
    and an index sharded over 4 coordinates of the card against an
    unsharded one on the corpus's vectors (32 queries, top-10): float32 ids
    exact and scores within 1e-5 (another GEMM shape sums in another
    order), bf16 scores within one bf16 step (they tie, so ids may swap). Reported: each shard's weight bytes and what it added beside
    the source tensors, each shard's pool bytes. The kernel checks (phase
    3) also run each kernel at a tp=2 shard's shape: both paged kernels at
    a chat's decode with H 16, Hkv 4; flash at the embedder's ingest batch
    with H 8 and at the 8B prefill with H 16.

39. mesh_train (after mesh_tp; ROADMAP 10b) — JAX's dry-run train steps
    on repeated coordinates of the card, Llama-3-8B's widths cut to
    ``TRAIN_MESH_LAYERS`` (4) layers in bf16, random weights from the seed,
    a batch of 4 × 257 tokens (three rows padded), ``torch.optim.AdamW`` at
    optax.adamw(1e-3)'s defaults: the dp=2 × tp=2 step (``llama_loss``, the
    batch split over dp) and the dp=1 × pp=2 × tp=2 GPipe step
    (``pipeline_loss``, 2 microbatches). Gates: a finite loss, every tensor
    moved, none of the three kernels launched (wrappers and card). The dp
    × tp mesh names the card twice (``cuda:0`` and ``cuda``), so each dp
    group holds its own copy of every slice, as on two cards: the step
    sums the copies' gradients and they must be bit-equal after it. Its
    loss, each leaf's gradient and each leaf's AdamW update are held to
    the plain step's on the same weights and batch, each AdamW update to
    AdamW on its own gradient, within ``DP_TP_LIMITS``; the same readings
    of the plain step on half the batch (one dp group's) must lie past
    each limit. Then at ``EXACT_LAYERS`` (2) in
    float32: ``pipeline_loss`` and every gradient at pp=2 within 1e-4
    (relative to each leaf's largest) of pp=1's. Reported: step and
    forward-backward ms, peak memory.

40. mesh_sp — sequence parallelism on sp=2 × tp=2: the contiguous
    engine's ring prefill of a 4,001-token prompt (Llama-3-8B's widths, 2
    layers, float32) against the sp=1 engine's plain attention: logits
    within 1e-3, 8 greedy tokens equal, no kernel launched; then one
    ``/chat`` through ``build_pipeline`` with ``USE_PAGED_KV=0``,
    ``MESH_SP=2``, ``MESH_TP=2`` (the mesh passed in) at ``CONTIG_LAYERS``
    on the shared bf16 weights over 256 chunks: answered, not degraded,
    both prefills on the ring, no flash launch (the encoders run plain
    attention at sp > 1, as JAX picks it), the card's counts 0 too; then
    ``MESH_PP=2``: a paged engine on pp=2 of the card at 4 layers, greedy
    tokens equal to one without a mesh.

41. mesh_ep — a MoE model on dp=1 × ep=2 × tp=2 (``MOE_EP_RULES``):
    Mixtral-8x7B's widths at 2 layers in bf16 behind ``build_pipeline``
    (warmup, 256 chunks, one chat; the paged kernel once per layer per tp
    shard per sub-step, = the card's; no choice dropped), one prompt's
    prefill and 4 decode steps against the single-device engine in bf16
    and int8 (within the logits limit, 2 × 2 × 4 launches, = the card's);
    ``bench.py``'s ``moe`` geometry in float32: greedy tokens equal to one
    device's; one ep train step (``moe_loss``, AdamW) at Mixtral's widths
    and one layer, its mesh naming the card twice along ep, gated and held
    to the plain step as mesh_train's dp × tp step, within ``EP_LIMITS``.

42. sanitize (right after the replica phases, on the tier's weights) — the
    runtime sanitizer on the card: ``SENTIO_SANITIZE=1`` while the phase's
    objects are built (the prior value after), a wrapper over
    ``runtime.paged.check_engine_invariants`` counting and timing each
    tick's check per engine. Two thread-mode replicas under ``Settings()``
    with the prefix cache, the warmed head and AFFINITY_STICKINESS 0.5:
    warmup, 64 chunks, then 12 generations at once over two 512-token
    heads (the first a stream dropped after its first piece) beside two
    /chat answers, a lone greedy request, and replica 0 quarantined and
    rebuilt (armed) under traffic; then an int8 engine at the serving
    geometry driven directly. Gates: every engine, lock and lockset armed;
    each replica's ticks and the int8 engine's checked; no sanitizer error
    but one injected on the quiescent int8 engine (a page popped from its
    free list: the next tick names it, and once it is back the engine
    steps clean), no tick failure; a check with slots active under
    ``torch.cuda.set_sync_debug_mode("error")`` raises nothing; both
    replicas served, hit and hold pages in their trees, the dropped stream
    cancelled; the lone greedy text equal to the unarmed ``replicas_2``
    answer; both paged kernels once per layer per sub-step, flash
    launched, each count equal to the card's. Reported: the check's host
    ms per tick (p50, max) beside the ticks' own ms, the pools' pages.

``slice_contig`` runs Llama-3-8B cut to 16 of its layers (``CONTIG_LAYERS``)
since convert_serve.

``--only-new`` runs the build, the kernel checks and phase 37
(convert_serve, with provider_settings) only (on weights made afresh from
the seed) and ends without the result lines.
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
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from typing import Optional

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


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, with the seconds since the script started (``t``)."""
    print(json.dumps({"phase": phase, "t": round(time.perf_counter() - T_START, 1), **fields}),
          flush=True)


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
                n_chunks: int = N_CHUNKS, **weights):
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

    docs, words = corpus(n_chunks)
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
    encoders = {"embedder": pipeline.embedder, "reranker": pipeline.reranker}
    forwards0 = {k: getattr(e, "forwards", 0) for k, e in encoders.items()}
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
            "card": card_delta(torch, card0),
            "forwards": {k: getattr(e, "forwards", 0) - forwards0[k]
                         for k, e in encoders.items()}}


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


def run_slice(torch, dev, phase: str, settings, shared=None, n_chats: int = 3,
              mesh=None, n_chunks: int = N_CHUNKS, every_expert: bool = True) -> dict:
    """The paged slice: build, warm up, ingest, then ``n_chats`` chats in a
    counted window (:func:`chat_window`), each chat's generate and verify
    admissions recorded (:func:`record_admissions`). A MoE engine's routing
    over the window, from its stats, is reported: choices routed to each
    expert, dropped (must be none at the no-drop capacity factor) and
    padding's; with ``every_expert`` each expert must have had a choice.
    On a ``mesh`` the pipeline is built on it, and the decode kernel runs
    once per layer per tp shard per sub-step."""
    from sentio_tpu_torch.models.moe import MoeConfig

    extra = {"mesh": mesh} if mesh is not None else {}
    pipeline, docs, words, warm = build_slice(torch, dev, phase, settings, shared,
                                              n_chunks=n_chunks, **extra)
    engine = pipeline.generator.provider.engine
    moe = isinstance(engine.cfg, MoeConfig)
    questions = slice_questions(docs, words)[:n_chats]
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
    torch.cuda.synchronize()
    stats = engine.stats()
    routing = ({"routed": [b - a for a, b in zip(stats0["moe_routed"], stats["moe_routed"])],
                **{k: stats[f"moe_{k}"] - stats0[f"moe_{k}"] for k in ("dropped", "padding")}}
               if moe else None)

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
    n_layers = engine.cfg.n_layers * engine.tp  # a launch a layer a tp shard
    emit(phase, chats=len(chats), seconds=window["seconds"], decode_sub_steps=sub_steps,
         launches=launches, device_launches=card, expected_decode_launches=n_layers * sub_steps,
         encoder_forwards=window["forwards"], tp=engine.tp,
         pipeline_depth=engine.pipeline_depth, prefix_cache=engine._radix is not None,
         **{k: stats[k] - stats0[k] for k in ENGINE_COUNTERS},
         prefix_cache_pages=stats["prefix_cache_pages"],
         peak_memory=torch.cuda.max_memory_allocated(),
         **({"routing": routing} if moe else {}))
    if moe and (routing["dropped"] or (every_expert and not all(routing["routed"]))):
        raise AssertionError(f"{phase}: a choice was dropped at the no-drop capacity factor, "
                             f"or an expert got no token: {routing}")
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
            "forwards": window["forwards"], "sub_steps": sub_steps,
            "questions": questions, "warmup": warm, "words": words, "routing": routing,
            "seconds": [seconds for _, seconds in chats], "admissions": calls,
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


# ------------------------------------------------- the last serve settings

SETTINGS_COLLECTION = "smoke"
WEB_CACHE_CHUNKS = 64
JWT_SECRET = "smoke-secret"
SMOKE_USERS = (("ada", "Str0ngPassword!"), ("bob", "An0therPassword!"))


class FakeRedis:
    """A Redis server on loopback for the cache's L2: RESP2 arrays in,
    PING / AUTH / SELECT / GET / SET (PX) / DEL, on threads, standard
    library only; every command is recorded."""

    def __init__(self) -> None:
        import socketserver
        import threading

        self.store: dict = {}
        self.commands: list = []
        outer = self

        class Handler(socketserver.StreamRequestHandler):
            def handle(self) -> None:
                while True:
                    line = self.rfile.readline()
                    if not line.startswith(b"*"):
                        return
                    args = []
                    for _ in range(int(line[1:])):
                        size = int(self.rfile.readline()[1:])
                        args.append(self.rfile.read(size + 2)[:-2])
                    outer.commands.append(args)
                    self.wfile.write(outer.reply(args))

        self.server = socketserver.ThreadingTCPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, name="fake-redis",
                                       daemon=True)
        self.thread.start()

    def reply(self, args: list) -> bytes:
        cmd = args[0].upper()
        if cmd in (b"PING",):
            return b"+PONG\r\n"
        if cmd in (b"AUTH", b"SELECT"):
            return b"+OK\r\n"
        if cmd == b"SET":
            self.store[args[1]] = args[2]
            return b"+OK\r\n"
        if cmd == b"GET":
            val = self.store.get(args[1])
            return b"$-1\r\n" if val is None else b"$%d\r\n%s\r\n" % (len(val), val)
        if cmd == b"DEL":
            return b":%d\r\n" % int(self.store.pop(args[1], None) is not None)
        return b"-ERR unknown command\r\n"

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


class FakeQdrant:
    """Qdrant's REST API on loopback, as the store uses it: collections,
    upsert, retrieve by id, count, delete, scroll, search and batch search,
    with exact cosine scores over a numpy matrix; standard library and
    numpy only. :meth:`stop` takes it down: the listener closes and every
    open connection is dropped at its next request."""

    def __init__(self) -> None:
        import http.server
        import threading

        self.collections: dict = {}
        self.down = False
        self.requests = 0
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args) -> None:
                pass

            def _serve(self) -> None:
                if outer.down:
                    self.close_connection = True
                    return
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n)) if n else {}
                outer.requests += 1
                status, payload = outer.handle(self.command, self.path.split("?")[0], body)
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            do_GET = do_POST = do_PUT = do_DELETE = _serve

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.server.daemon_threads = True
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, name="fake-qdrant",
                                       daemon=True)
        self.thread.start()

    @staticmethod
    def ok(result):
        return 200, {"status": "ok", "result": result}

    def handle(self, method: str, path: str, body: dict):
        import numpy as np

        parts = [p for p in path.split("/") if p]
        if parts == ["collections"]:
            return self.ok({"collections": [{"name": n} for n in self.collections]})
        name = parts[1]
        if len(parts) == 2:
            if method == "GET":
                return (self.ok({"status": "green"}) if name in self.collections
                        else (404, {"status": {"error": "not found"}}))
            if method == "PUT":
                self.collections[name] = {"points": {}, "matrix": None}
                return self.ok(True)
            if method == "DELETE":
                self.collections.pop(name, None)
                return self.ok(True)
        col = self.collections.get(name)
        if col is None:
            return 404, {"status": {"error": "no collection"}}
        op = parts[-1]
        if op == "points" and method == "PUT":
            for pt in body["points"]:
                col["points"][pt["id"]] = pt
            col["matrix"] = None
            return self.ok({"status": "completed"})
        if op == "points":
            return self.ok([{"id": pid, "payload": None} for pid in body["ids"]
                            if pid in col["points"]])
        if op == "count":
            return self.ok({"count": len(col["points"])})
        if op == "delete":
            for pid in body["points"]:
                col["points"].pop(pid, None)
            col["matrix"] = None
            return self.ok({"status": "completed"})
        if op == "scroll":
            ids = sorted(col["points"])
            start = ids.index(body["offset"]) if "offset" in body else 0
            page = ids[start:start + body["limit"]]
            nxt = ids[start + body["limit"]] if start + body["limit"] < len(ids) else None
            return self.ok({"points": [{"id": pid, "payload": col["points"][pid]["payload"]}
                                       for pid in page], "next_page_offset": nxt})
        if col["matrix"] is None and col["points"]:
            ids = sorted(col["points"])
            m = np.asarray([col["points"][pid]["vector"] for pid in ids], np.float32)
            col["matrix"] = (ids, m / np.maximum(np.linalg.norm(m, axis=1, keepdims=True),
                                                 1e-9))

        def search(query: dict) -> list:
            if not col["points"]:
                return []
            ids, m = col["matrix"]
            q = np.asarray(query["vector"], np.float32)
            scores = m @ (q / max(float(np.linalg.norm(q)), 1e-9))
            order = np.argsort(-scores, kind="stable")[:query["limit"]]
            return [{"id": ids[i], "score": float(scores[i]),
                     "payload": col["points"][ids[i]]["payload"]} for i in order]

        if op == "search":
            return self.ok(search(body))
        if op == "batch":
            return self.ok([search(s) for s in body["searches"]])
        return 400, {"status": {"error": f"unhandled {path}"}}

    def stop(self) -> None:
        if self.down:
            return
        self.down = True
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)


def settings_weights(torch, dev) -> dict:
    """:func:`shared_weights`' dict made afresh from the seed, as
    ``build_pipeline`` makes them (for ``--only-new``)."""
    from sentio_tpu_torch.config import Settings
    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.ops.reranker import CrossEncoderReranker
    from sentio_tpu_torch.pipeline import make_embedder

    settings = Settings()
    embedder = make_embedder(settings, dev, SEED)
    reranker = CrossEncoderReranker(settings.rerank, device=dev,
                                    generator=torch.Generator(device=dev).manual_seed(SEED + 2))
    cfg = LlamaConfig.llama3_8b()
    return dict(llama_config=cfg,
                llama_params=init_llama(cfg, torch.Generator(device=dev).manual_seed(SEED + 3),
                                        dev),
                embedder_config=embedder.model_config, embedder_params=embedder.params,
                reranker_config=reranker.model_config, reranker_params=reranker.params)


def web_cache_docs(words) -> list:
    """The web cache's chunks: corpus-like text in words the corpus never
    uses, so BM25 finds nothing for a question made of them."""
    import numpy as np

    from sentio_tpu_torch.models.document import Document

    rng = np.random.default_rng(SEED + 11)
    letters = ["xy", "bu", "gh", "fw", "jo", "ec", "wh", "yq", "ux", "bz"]
    corpus_words = set(words)
    fresh = sorted({"".join(rng.choice(letters, size=3)) for _ in range(400)} - corpus_words)
    return [Document(text=" ".join(rng.choice(fresh, size=60)), id=f"web-{i:02d}",
                     metadata={"source": "web-cache"}) for i in range(WEB_CACHE_CHUNKS)]


def serve_settings_check(torch, dev, shared) -> dict:
    """Every setting a one-card deployment can set that the port took last,
    at once, behind ``create_server`` on 127.0.0.1 at full width on
    ``shared``'s weights: AUTH_ENABLED=1 (two users), CACHE_BACKEND=
    multi_tier (a fake Redis on loopback), USE_SCORERS=1, WEB_CACHE_PATH (64
    chunks saved by the port, loaded by the server), INDEX_BACKEND=qdrant (a
    fake Qdrant on loopback holding the 2,048 chunks) and METRICS_ENABLED=0.
    See the module's docstring (phase 35) for the gates."""
    import gc
    import tempfile
    import threading

    from sentio_tpu_torch.config import (
        AuthConfig,
        CacheConfig,
        GeneratorConfig,
        ObservabilityConfig,
        RetrievalConfig,
        Settings,
    )
    from sentio_tpu_torch.infra.flight import get_flight_recorder
    from sentio_tpu_torch.infra.resilience import FallbackResponseCache, LLMFallback
    from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
    from sentio_tpu_torch.ops.embedder import TorchEmbedder
    from sentio_tpu_torch.ops.vector_store import QdrantVectorStore
    from sentio_tpu_torch.serve.app import create_server

    phase = "serve_settings"
    t_phase = time.perf_counter()
    redis, qdrant = FakeRedis(), FakeQdrant()
    tmp = tempfile.mkdtemp(prefix="smoke-settings-")
    docs, words = corpus(N_CHUNKS)
    web_docs = web_cache_docs(words)
    # the web cache: embedded with the server's embedder weights, saved
    # by the port, loaded by build_pipeline from WEB_CACHE_PATH
    t0 = time.perf_counter()
    saver = TorchEmbedder(Settings().embedder, params=shared["embedder_params"],
                          model_config=shared["embedder_config"], device=dev)
    web_index = TorchDenseIndex(saver.dimension, device=dev)
    web_index.add(web_docs, saver.embed_many([d.text for d in web_docs]))
    web_index.save(f"{tmp}/web_cache")
    saver.close()
    web_cache_s = time.perf_counter() - t0
    settings = Settings(
        retrieval=RetrievalConfig(use_scorers=True, web_cache_path=f"{tmp}/web_cache",
                                  index_backend="qdrant", qdrant_url=qdrant.url,
                                  collection_name=SETTINGS_COLLECTION),
        generator=GeneratorConfig(max_new_tokens=MAX_TOKENS, verifier_max_tokens=MAX_TOKENS),
        cache=CacheConfig(backend="multi_tier", redis_url=f"redis://127.0.0.1:{redis.port}/0"),
        auth=AuthConfig(enabled=True, jwt_secret=JWT_SECRET),
        observability=ObservabilityConfig(metrics_enabled=False))
    pipeline, _docs, _words, warm = build_slice(torch, dev, phase, settings, shared,
                                                ingest=False)
    result: dict = {"web_cache_s": web_cache_s, "warmup_s": warm["seconds"]}
    server = thread = None
    try:
        store, retriever = pipeline.index, pipeline.retriever
        if not isinstance(store, QdrantVectorStore) or retriever.web_cache is None \
                or [s.name for s in retriever.scorers] != ["keyword", "recency", "semantic",
                                                            "mmr"] \
                or pipeline.web_cache_index.size != WEB_CACHE_CHUNKS:
            raise AssertionError(f"{phase}: the pipeline is not what the settings ask: "
                                 f"{type(store).__name__}, {retriever}")
        t0 = time.perf_counter()
        pipeline.ingest(docs)
        torch.cuda.synchronize()
        result["ingest_s"] = time.perf_counter() - t0
        points = len(qdrant.collections[SETTINGS_COLLECTION]["points"])
        emit(f"{phase}_ingest", chunks=len(docs), seconds=result["ingest_s"],
             qdrant_points=points, bm25_size=pipeline.bm25_index.size,
             qdrant_requests=qdrant.requests, web_cache_s=web_cache_s)
        if not points == pipeline.bm25_index.size == store.size == N_CHUNKS:
            raise AssertionError(f"{phase}: {points} points in Qdrant, BM25 holds "
                                 f"{pipeline.bm25_index.size}, of {N_CHUNKS} chunks")
        server = create_server(settings, pipeline, host="127.0.0.1", port=0,
                               fallback=(FallbackResponseCache(f"{tmp}/fallback"),
                                         LLMFallback()))
        thread = threading.Thread(target=server.serve_forever, name="smoke-settings",
                                  daemon=True)
        thread.start()
        client = HttpClient(server.server_address[1])
        auth = server.auth_manager
        for name, password in SMOKE_USERS:
            auth.create_user(name, password)

        # ---- auth: no token is a 401 with no kernel launched; open paths
        counters = wrappers()
        before = {name: k.launches for name, k in counters.items()}
        denied = client.json("POST", "/chat", {"question": "who may ask?"})
        bad = client.json("POST", "/chat", {"question": "who may ask?"},
                          {"Authorization": "Bearer not.a.token"})
        leaked = {name: k.launches - before[name] for name, k in counters.items()}
        open_paths = {path: client.request("GET", path)[0]
                      for path in ("/", "/health", "/metrics")}
        tokens = {}
        for name, password in SMOKE_USERS:
            status, _, body = client.json("POST", "/auth/token",
                                          {"username": name, "password": password})
            if status != 200:
                raise AssertionError(f"{phase}: /auth/token for {name}: {status} {body}")
            tokens[name] = {"Authorization": f"Bearer {body['access_token']}"}
        wrong = client.json("POST", "/auth/token", {"username": "ada", "password": "nope"})
        result["auth"] = {"no_token": [denied[0], denied[2]], "bad_token": [bad[0], bad[2]],
                          "launches_without_token": leaked, "open_paths": open_paths,
                          "wrong_password": wrong[0]}
        emit(f"{phase}_auth", **result["auth"])
        if denied[0] != 401 or denied[2] != {"error": "missing credentials"} \
                or bad[0] != 401 or bad[2] != {"error": "invalid credentials"} \
                or any(leaked.values()) or set(open_paths.values()) != {200} \
                or wrong[0] != 401:
            raise AssertionError(f"{phase}: auth: {result['auth']}")

        # ---- chats: each user's, distinct questions, launches counted; one
        # with the embedding cache emptied first
        emb, ce = pipeline.embedder, pipeline.reranker
        engine, service, rs = pipeline.generator.provider.engine, pipeline.service, \
            pipeline.replica_set
        questions = [f"What does the corpus say about {words[400 + 3 * i]} and "
                     f"{words[401 + 3 * i]}?" for i in range(5)]
        service.wait_idle()
        ledger0 = rs.tenants.stats()["per_tenant"]
        sub_steps0, stats0 = engine.total_sub_steps, engine.stats()
        fwd0 = (emb.forwards, ce.forwards)
        card0 = card_launches(torch)
        for kernel in counters.values():
            kernel.launches = 0
        chats, cold = [], None
        for i, question in enumerate(questions):
            user = SMOKE_USERS[i % 2][0]
            headers = {**tokens[user], "X-Tenant": "spoofed-tenant"}
            if i == len(questions) - 1:
                cleared = emb.cache.clear()
                cold = {"entries_cleared": cleared, "forwards_before": emb.forwards}
            t0 = time.perf_counter()
            status, _, body = client.json("POST", "/chat", {"question": question}, headers)
            seconds = time.perf_counter() - t0
            check_http_chat(phase, i, status, body)
            chats.append({"user": user, "seconds": seconds,
                          "tenant": body["metadata"].get("tenant"),
                          "stage_ms": body["metadata"]["node_timings_ms"]})
        cold["forwards"] = emb.forwards - cold["forwards_before"]
        service.wait_idle()
        launches = {name: k.launches for name, k in counters.items()}
        card = card_delta(torch, card0)
        sub_steps = engine.total_sub_steps - sub_steps0
        forwards = {"embedder": emb.forwards - fwd0[0], "cross_encoder": ce.forwards - fwd0[1]}
        predicted_flash = (forwards["embedder"] * emb.model_config.n_layers
                           + forwards["cross_encoder"] * ce.model_config.n_layers)
        ledger = rs.tenants.stats()["per_tenant"]
        admitted = {t: ledger.get(t, {}).get("admitted", 0)
                    - ledger0.get(t, {}).get("admitted", 0) for t in ledger}
        result["chats"] = {
            "chats": chats, "launches": launches, "device_launches": card,
            "decode_sub_steps": sub_steps, "forwards": forwards,
            "predicted_flash": predicted_flash, "cold_chat": cold,
            "tenants_admitted": admitted,
            "graph_captures_delta": engine.stats()["graph_captures"]
            - stats0["graph_captures"]}
        emit(f"{phase}_chats", **result["chats"])
        if launches["paged_attention"] != engine.cfg.n_layers * sub_steps or sub_steps <= 0 \
                or launches["paged_attention_quant"]:
            raise AssertionError(f"{phase}: decode launches are not one bf16 paged launch "
                                 f"per layer per sub-step: {launches}, {sub_steps} sub-steps")
        if launches["flash_attention"] != predicted_flash or predicted_flash <= 0:
            raise AssertionError(f"{phase}: {launches['flash_attention']} flash launches, the "
                                 f"embedder's and cross-encoder's forwards predict "
                                 f"{predicted_flash}: {forwards}")
        if cold["forwards"] < 1 or any("scorers" not in c["stage_ms"] for c in chats):
            raise AssertionError(f"{phase}: the scorers did not run through the kernel: "
                                 f"{cold}, {[c['stage_ms'] for c in chats]}")
        check_card(phase, card, launches)
        if result["chats"]["graph_captures_delta"]:
            raise AssertionError(f"{phase}: a graph was captured after warmup")
        want = {f"user:{name}" for name, _ in SMOKE_USERS}
        if {c["tenant"] for c in chats} != want or set(t for t, n in admitted.items() if n) \
                != want or "spoofed-tenant" in ledger:
            raise AssertionError(f"{phase}: the tenant ledger is not keyed by the principal: "
                                 f"{[c['tenant'] for c in chats]}, {admitted}")

        # ---- the cache tiers: a repeated question; the tiered set and get
        repeat0 = emb.get_stats()["cache"]["hits"]
        status, _, again = client.json("POST", "/chat", {"question": questions[0]},
                                       tokens["ada"])
        check_http_chat(phase, len(questions), status, again)
        cache = server.chat_handler.cache_manager
        held = cache.get_query_response(questions[0])
        key, value = "smoke:tiered", {"question": questions[0],
                                      "answer_chars": len(again["answer"])}
        cache.tiered_set(key, value)
        in_redis = json.loads(redis.store.get(b"sentio:smoke:tiered", b"null"))
        cache.l1.delete(key)
        read_back = cache.tiered_get(key)
        result["cache"] = {"l1_holds_the_answer": bool(held and held.get("answer")),
                           "repeat_embed_cache_hits": emb.get_stats()["cache"]["hits"] - repeat0,
                           "redis_value": in_redis, "tiered_get": read_back,
                           "promoted_to_l1": cache.l1.get(key) == value,
                           "redis_commands": sorted({c[0].decode() for c in redis.commands})}
        emit(f"{phase}_cache", **result["cache"])
        if not (result["cache"]["l1_holds_the_answer"] and in_redis == value
                and read_back == value and result["cache"]["promoted_to_l1"]
                and result["cache"]["repeat_embed_cache_hits"] > 0):
            raise AssertionError(f"{phase}: the cache tiers: {result['cache']}")

        # ---- the web cache's chunk first for a question it answers
        question = web_docs[5].text
        status, _, body = client.json("POST", "/chat", {"question": question}, tokens["bob"])
        check_http_chat(phase, len(questions) + 1, status, body)
        hits = retriever.retrieve(question, settings.retrieval.top_k)
        result["web_cache"] = {"top_ids": [d.id for d in hits],
                               "bm25_hits": len(pipeline.bm25_index.retrieve(question, 10))}
        emit(f"{phase}_web_cache", **result["web_cache"])
        if hits[0].id != web_docs[5].id:
            raise AssertionError(f"{phase}: the web cache's chunk is not first: "
                                 f"{result['web_cache']}")

        # ---- /metrics with METRICS_ENABLED=0: the families are recorded
        samples = parse_prometheus(client.request("GET", "/metrics")[2].decode())
        chat_requests = sum(v for (name, labels), v in samples.items()
                            if name == "sentio_requests_total" and ("endpoint", "/chat") in labels)
        if chat_requests < len(questions) + 2:
            raise AssertionError(f"{phase}: /metrics counts {chat_requests} /chat requests")

        # ---- Qdrant goes down: its breaker opens, chats go on from BM25
        qdrant.stop()
        outage = []
        for i in range(8):
            query_id = f"settings-outage-{i}"
            t0 = time.perf_counter()
            status, _, body = client.json("POST", "/chat", {
                "question": f"Where is {words[(300 + 7 * i) % len(words)]} mentioned?",
                "thread_id": query_id},
                tokens["ada"])
            record = get_flight_recorder().get(query_id) or {}
            outage.append({"status": status, "seconds": time.perf_counter() - t0,
                           "legs_dropped": record.get("retrieval_legs_dropped"),
                           "breaker": store.breaker.state.value,
                           "sources": len(body.get("sources", []))})
            check_http_chat(phase, 100 + i, status, body)
            if outage[-1]["legs_dropped"] != ["dense"]:
                raise AssertionError(f"{phase}: chat {i} in the outage: {outage[-1]}")
            if i and outage[-2]["breaker"] == "open":
                break  # the chat after the breaker opened
        detailed = client.json("GET", "/health/detailed", headers=tokens["ada"])[2]
        breakers = detailed["components"]["breakers"]
        result["outage"] = {"chats": outage, "breakers": breakers,
                            "dense_index": detailed["components"]["dense_index"]}
        emit(f"{phase}_outage", **result["outage"])
        name = f"qdrant:{SETTINGS_COLLECTION}"
        if outage[-2]["breaker"] != "open" or breakers.get(name, {}).get("state") != "open" \
                or "replica_0" not in breakers:
            raise AssertionError(f"{phase}: the store's breaker: {result['outage']}")
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
            thread.join(timeout=10.0)
        pipeline.close()
        qdrant.stop()
        redis.close()
    del pipeline, store, retriever, engine, service, rs, emb, ce
    gc.collect()
    torch.cuda.empty_cache()
    result["memory_allocated_after_close"] = torch.cuda.memory_allocated()
    result["seconds"] = time.perf_counter() - t_phase
    emit(phase, seconds=result["seconds"])
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




def device_kernels(prof) -> list:
    """(name, ms, count) of each device function a finished profile
    recorded, summed from its raw records (``key_averages()`` would first
    build the whole event tree in Python: tens of seconds for a chat's
    ~10^5 kernels)."""
    from torch.autograd import DeviceType

    acc: dict = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ms, n = acc.get(e.name(), (0.0, 0))
            acc[e.name()] = (ms + e.duration_ns() / 1e6, n + 1)
    return [(name, ms, n) for name, (ms, n) in acc.items() if ms > 0]


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
    kernels = device_kernels(prof)
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
# slice_spec's target depth: 16 of Llama-3-8B's 32 layers keeps the whole
# run inside its time limit (at 32 the spec phases took ~160 s of ~1,151)
SPEC_LAYERS = 4
# slice_contig's depth: half of Llama-3-8B's 32 layers
CONTIG_LAYERS = 16
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


def cut_depth(weights: dict, n_layers: int) -> dict:
    """``weights`` (a :func:`shared_weights` dict) with the target cut to its
    first ``n_layers`` layers: views, no copy."""
    cfg = dataclasses.replace(weights["llama_config"], n_layers=n_layers)
    params = {k: v for k, v in weights["llama_params"].items()
              if not k.startswith("layers_") or int(k.split("_")[1]) < n_layers}
    return {**weights, "llama_config": cfg, "llama_params": params}


def run_spec_slice(torch, dev, settings, weights: dict, draft: dict) -> dict:
    """slice_spec: the /chat pipeline of ``settings`` with a draft, at full
    width, on the slices' Llama-3-8B tensors (``weights``): build, warm up (both
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
    cut = cut_depth(weights, n_layers)
    cfg, params = cut["llama_config"], cut["llama_params"]
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
# 12 of the serving embedder's 24 layers since convert_serve
WIDE_DIM, WIDE_LAYERS, WIDE_STEPS = 1024, 12, 20
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
    """20 training steps at the serving embedder's width (dim 1,024, 16
    heads; ``WIDE_LAYERS`` 12 of its 24 layers) with train-encoder's other
    defaults, in bf16 compute
    (step ms, peak memory) and again in float32 compute from the same
    float32 masters. JAX's recipe collapses at this depth within these 20
    steps (every embedding alike, the loss at ln(batch)), in float32 as in
    bf16, so the loss is reported, not required to fall. Gates: every loss
    finite in both runs; step 0's loss in bf16 within 5e-2 of float32's
    (the same batch and weights; step 0 has lr 0); the masters of every
    layer moved in both (gradients reach every layer)."""
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
# bursts of each replica count, each on questions of its own (2: cut from 3
# to make room for mesh_tp)
REPLICA_ROUNDS = 2
# the replica tier's, the worker tier's and the elastic fleet's depth: 8 of
# Llama-3-8B's 32 layers (cut to 16 to make room for mesh_tp, to 8 for
# mesh_train, mesh_sp and mesh_ep)
TIER_LAYERS = 8
# replicas_2_process's rounds in the full run, for its time limit
# (``--worker-rounds`` runs REPLICA_ROUNDS)
PROCESS_ROUNDS = 1
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
    stages = [b["metadata"].get("node_timings_ms", {}) for kind, _a, b, _s in out
              if kind == "json"]
    return {"chat_s": seconds, "p50_s": percentile(seconds, 0.5),
            # each stage's mean ms over the JSON chats (retrieve, rerank and
            # select in the router; generate and verify through the tier)
            "stage_ms": {k: sum(t.get(k, 0.0) for t in stages) / len(stages)
                         for k in sorted({k for t in stages for k in t})},
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
    Chrome trace with tick slices (``info`` runs beside ``trace``). The tiny
    presets cannot run on the card: their head dims (16) are not among the
    kernels' tiles."""
    import os
    import threading
    from pathlib import Path

    root = Path(__file__).resolve().parent
    # the subprocesses build their own 8B pipeline on the card: hand this
    # process's cached blocks back first
    gc.collect()
    torch.cuda.empty_cache()
    env = dict(os.environ, LLM_MAX_TOKENS=str(MAX_TOKENS), VERIFIER_MAX_TOKENS=str(MAX_TOKENS))
    cmd = [sys.executable, "-m", "sentio_tpu_torch"]
    # info (a CUDA context, no model) runs beside trace, timed on its own
    t_info = time.perf_counter()
    info_proc = subprocess.Popen([*cmd, "info"], cwd=root, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
    info_done: dict = {}

    def wait_info() -> None:
        info_done["out"] = info_proc.communicate(timeout=300)
        info_done["s"] = time.perf_counter() - t_info

    waiter = threading.Thread(target=wait_info, name="smoke-cli-info", daemon=True)
    waiter.start()
    try:
        with tempfile.TemporaryDirectory(prefix="smoke-trace-") as tmp:
            chrome_path = Path(tmp) / "trace.json"
            t0 = time.perf_counter()
            proc = subprocess.run([*cmd, "trace", "What does the paged cache hold?",
                                   "--chrome", str(chrome_path)], cwd=root, env=env,
                                  capture_output=True, text=True, timeout=600)
            trace_s = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"cli trace: exit {proc.returncode}: "
                                     f"{proc.stderr[-3000:]}")
            trace = json.loads(proc.stdout)
            chrome = json.loads(chrome_path.read_text())
        waiter.join(timeout=300)
    finally:
        if info_proc.poll() is None:
            info_proc.kill()
        waiter.join(timeout=30)
    if "out" not in info_done:
        raise AssertionError("cli info did not finish within 300 s")
    (info_out, info_err), info_s = info_done["out"], info_done["s"]
    if info_proc.returncode != 0:
        raise AssertionError(f"cli info: exit {info_proc.returncode}: {info_err[-2000:]}")
    info = json.loads(info_out)
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


# ------------------------------------------------ the process and socket tier

# a worker's CUDA context and its allocator's slack: what a worker may add
# to the card's used memory beyond its own reserved peak. A private copy of
# the weights would add ~16 GB more.
WORKER_SLACK_BYTES = 2 << 30
SOCKET_TOKEN = "chip-smoke-socket-token"
LONE_PROMPT = ("Zyx vault 17: a lone greedy request that no radix tree holds, "
               "decoded alone on one replica")
RESUME_PROMPT_CHARS = 400


def card_used(torch) -> int:
    """The card's used bytes, every process's (the router's allocator sees
    only its own)."""
    free, total = torch.cuda.mem_get_info()
    return total - free


class CardPeak:
    """The card's largest used bytes (:func:`card_used`), sampled every
    ``interval_s`` on a thread of its own until :meth:`stop`."""

    def __init__(self, torch, interval_s: float = 0.05) -> None:
        import threading

        self.torch, self.interval_s, self.peak = torch, interval_s, card_used(torch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="smoke-card-peak", daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.peak = max(self.peak, card_used(self.torch))

    def stop(self) -> int:
        self._stop.set()
        self._thread.join(timeout=10.0)
        return self.peak


def tensor_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def lone_greedy(rs) -> dict:
    """One greedy request alone on the set (no radix hit anywhere): the
    text every mode must give on the same weights."""
    rs.wait_idle()
    result = rs.generate(LONE_PROMPT, max_new_tokens=MAX_TOKENS, temperature=0.0,
                         timeout_s=300)
    return {"text": result.text, "tokens": list(result.tokens), "replica": result.replica_id}


def worker_reports(rs) -> list:
    """Each worker's stats: its service's counters with its own process's
    launch tallies, device counts and memory under ``worker``."""
    return [svc.stats() for svc in rs.services]


def worker_deltas(before: list, after: list) -> list:
    """Per worker: sub-steps, captures, completed chats, each wrapper's
    launches and the card's split / combine counts of the paged kernels."""
    rows = []
    for b, a in zip(before, after):
        wb, wa = b["worker"], a["worker"]
        launches = {k: wa["launches"][k] - wb["launches"][k] for k in wa["launches"]}
        card = {k: [x - y for x, y in zip(wa["device_launches"][k],
                                           wb["device_launches"].get(k, [0, 0]))]
                for k in wa.get("device_launches", {})}
        rows.append({"pid": wa["pid"], "sub_steps": a["sub_steps"] - b["sub_steps"],
                     "graph_captures": a["graph_captures"] - b["graph_captures"],
                     "completed": a["completed"] - b["completed"], "launches": launches,
                     "device_launches": card})
    return rows


def check_worker_launches(phase: str, rows: list, n_layers: int,
                          kernel: str = "paged_attention") -> None:
    """In each worker: one paged launch per layer per decode sub-step (the
    wrapper's count, added per graph replay), the card's split and combine
    counts equal to it, no other kernel launched, no capture."""
    for i, r in enumerate(rows):
        want = n_layers * r["sub_steps"]
        others = {k: n for k, n in r["launches"].items() if k != kernel and n}
        card = r["device_launches"].get(kernel, [0, 0])
        if r["launches"][kernel] != want or card != [want, want] or others \
                or r["graph_captures"]:
            raise AssertionError(f"{phase}: worker {i} launched {r['launches']} (card {card}) "
                                 f"for {r['sub_steps']} sub-steps x {n_layers} layers, "
                                 f"captures {r['graph_captures']}")


def worker_settings(n_replicas: int, mode: str, **serve):
    from sentio_tpu_torch.config import GeneratorConfig, ServeConfig, Settings

    return Settings(generator=GeneratorConfig(max_new_tokens=MAX_TOKENS,
                                              verifier_max_tokens=MAX_TOKENS),
                    serve=ServeConfig(replicas=n_replicas, replica_mode=mode,
                                      affinity_stickiness=REPLICA_STICKINESS, **serve))


def worker_server(torch, dev, phase: str, settings, weights: dict, docs):
    """``build_pipeline`` under ``settings`` (a worker mode) on the shared
    ``weights``, each worker's spawn metered (the card's used memory before
    and after it, beside the worker's own allocator at ready), the
    workers warmed at once, then ingested and behind ``create_server``.
    Gates: every worker captured every graph variant and holds the head;
    each worker's rise at spawn is its reserved memory plus at most
    ``WORKER_SLACK_BYTES``, and its reserved memory at ready is less than
    the weights' bytes (a private copy shows in one or the other)."""
    import gc
    import threading

    from sentio_tpu_torch.pipeline import build_pipeline
    from sentio_tpu_torch.runtime import worker
    from sentio_tpu_torch.serve.app import create_server

    gc.collect()
    torch.cuda.empty_cache()
    weight_bytes = tensor_bytes(weights["llama_params"])
    spawns: list = []
    init = worker.ProcessReplica.__init__

    def metered(self, *args, **kwargs):
        used0 = card_used(torch)
        t0 = time.perf_counter()
        init(self, *args, **kwargs)
        mem = self.ready_info["worker"].get("memory", {})
        spawns.append({"replica": self.replica_id, "pid": self.pid,
                       "seconds": time.perf_counter() - t0,
                       "card_rise": card_used(torch) - used0, "reserved": mem.get("reserved"),
                       "allocated": mem.get("allocated")})

    used0 = card_used(torch)
    peak = CardPeak(torch)
    worker.ProcessReplica.__init__ = metered
    t0 = time.perf_counter()
    try:
        pipeline = build_pipeline(settings, device=dev, seed=SEED, **weights)
    finally:
        worker.ProcessReplica.__init__ = init
    build_s = time.perf_counter() - t0
    used_built = card_used(torch)
    try:
        warm = pipeline.warmup()
        used_warm = card_used(torch)
        rs = pipeline.replica_set
        reports = worker_reports(rs)
        per = warm["per_replica"]
        result = {"build_s": build_s, "warmup_s": warm["seconds"],
                  "replica_seconds": [r["seconds"] for r in per],
                  "captures": [r["graph_captures"] for r in per],
                  "head_tokens": warm.get("head_tokens"), "spawns": spawns,
                  "weights_bytes": weight_bytes, "card_used_before": used0,
                  "card_used_built": used_built, "card_used_warm": used_warm,
                  "worker_memory": [r["worker"].get("memory") for r in reports],
                  "workers": rs.workers(), "router_allocated": torch.cuda.memory_allocated()}
        emit(f"{phase}_warmup", **result)
        for r in reports:
            w = r["worker"]
            if w["graphs_captured"] != w["graph_variants"] or not w["graphs_frozen"] \
                    or w["foreign_modules"]:
                raise AssertionError(f"{phase}: a worker left graph variants uncaptured or "
                                     f"loaded JAX: {w}")
        if warm.get("head_tokens") is not None and min(warm["head_tokens"]) <= 0:
            raise AssertionError(f"{phase}: a worker does not hold the template head: {warm}")
        for s in spawns:
            if s["reserved"] is None or s["card_rise"] - s["reserved"] > WORKER_SLACK_BYTES \
                    or s["reserved"] >= weight_bytes:
                raise AssertionError(f"{phase}: worker {s['replica']} is not on the shared "
                                     f"weights: {s} against {weight_bytes} weight bytes")
        pipeline.ingest(docs)
    except BaseException:
        peak.stop()
        pipeline.close()
        raise
    result["card_peak"] = peak
    server = create_server(settings, pipeline, host="127.0.0.1", port=0)
    thread = threading.Thread(target=server.serve_forever, name=f"smoke-{phase}", daemon=True)
    thread.start()
    return pipeline, server, thread, result


def worker_burst(torch, phase: str, pipeline, client, words, offset: int) -> dict:
    """:func:`http_burst` on a worker set, in a counted window read from
    the workers' own stats: no chat degraded, each worker served a chat,
    every verify admission a radix hit, each worker's paged launches one per
    layer per sub-step and equal to its card counts, no capture, the
    router's flash launches (embedder, cross-encoder) equal to the card's
    and no paged launch in the router, no tenant reservation pending;
    reported: p50 / p95, each worker's chats, duty cycle and launches."""
    rs = pipeline.replica_set
    rs.wait_idle()
    hits = record_verifies(rs)
    for svc in rs.services:
        svc.reset_duty_cycle()
    before = worker_reports(rs)
    window = LaunchWindow(torch)
    t0 = time.perf_counter()
    out = http_burst(client, words, REPLICA_JSON_CHATS, REPLICA_SSE_CHATS, offset)
    wall_s = time.perf_counter() - t0
    rs.wait_idle()
    router, router_card = window.read()
    for svc in rs.services:
        del svc.generate  # the recording wrapper
    after = worker_reports(rs)
    rows = worker_deltas(before, after)
    result = check_burst(phase, out)
    tenants = rs.tenants.stats()["per_tenant"]
    result.update(wall_s=wall_s, workers=rows, completed=[r["completed"] for r in rows],
                  router_view=[a["router_view"] for a in after],
                  duty_cycle=[svc.duty_cycle() for svc in rs.services],
                  telemetry_duty_cycle=[(svc._telemetry.get("stats") or {}).get("duty_cycle")
                                        for svc in rs.services],
                  verify_prefix_hit_tokens=hits, router_launches=router,
                  router_device_launches=router_card,
                  tenants={t: tenants[t] for t in ("a", "b")})
    emit(phase, offset=offset, **result)
    verifies = [h for per in hits.values() for h in per]
    if len(verifies) != REPLICA_JSON_CHATS + REPLICA_SSE_CHATS or min(verifies) <= 0:
        raise AssertionError(f"{phase}: every verify admission must hit its worker's radix "
                             f"tree: {hits}")
    if min(result["completed"]) <= 0 or sum(r["sub_steps"] for r in rows) <= 0:
        raise AssertionError(f"{phase}: a worker served no chat: {rows}")
    check_worker_launches(phase, rows, pipeline.replica_set.services[0].engine.cfg.n_layers)
    if router["paged_attention"] or router["paged_attention_quant"] \
            or router["flash_attention"] <= 0:
        raise AssertionError(f"{phase}: the router decoded, or its encoders never launched "
                             f"flash: {router}")
    check_card(f"{phase}_router", router_card, router)
    if any(t["pending"] for t in result["tenants"].values()):
        raise AssertionError(f"{phase}: a tenant reservation was left pending: {tenants}")
    return result


def check_lone(phase: str, got: dict, ref: dict) -> None:
    if got["text"] != ref["text"]:
        raise AssertionError(f"{phase}: the lone greedy text differs from thread mode's: "
                             f"{got['text']!r:.120} vs {ref['text']!r:.120}")


def wait_healthy(rs, replica: int, rebuilds: int, timeout_s: float = 300.0) -> float:
    """Seconds until ``replica`` is HEALTHY again with ``rebuilds``
    rebuilds (and the set healthy)."""
    t0 = time.perf_counter()

    def done():
        health = rs.health_summary()
        row = health["replicas"][replica]
        return health["status"] == "healthy" and row["rebuilds"] >= rebuilds

    wait_for(done, timeout_s, f"replica {replica}'s rebuild #{rebuilds}")
    return time.perf_counter() - t0


def kill_burst(torch, pipeline, client, words, offset: int) -> dict:
    """SIGKILL worker 0 once it holds work in the middle of a burst: no
    caller fails (its shadowed tickets go to the survivor, its delivered
    streams resume there), the supervisor respawns it (healthy, one
    rebuild), its death is counted once in /metrics."""
    import threading

    rs = pipeline.replica_set
    rs.wait_idle()
    victim = rs.services[0]
    out: dict = {}

    def burst() -> None:
        out["burst"] = http_burst(client, words, REPLICA_JSON_CHATS, REPLICA_SSE_CHATS, offset)

    t = threading.Thread(target=burst, name="smoke-kill-burst", daemon=True)
    t.start()
    wait_for(lambda: victim.backlog() >= 2, 120.0, "worker 0 to hold work")
    time.sleep(0.5)  # into its decode
    backlog = victim.backlog()
    t_kill = time.perf_counter()
    victim.kill()
    t.join(timeout=HTTP_TIMEOUT_S + 60)
    if t.is_alive():
        raise AssertionError("worker_kill: the burst did not return")
    result = check_burst("worker_kill", out["burst"])
    respawn_s = wait_healthy(rs, 0, 1)
    samples = parse_prometheus(client.request("GET", "/metrics")[2].decode())
    deaths = {dict(labels)["replica"]: v for (name, labels), v in samples.items()
              if name == "sentio_tpu_replica_worker_deaths_total"}
    stats = rs.stats()
    result.update(victim_backlog_at_kill=backlog, respawn_s=respawn_s,
                  kill_to_healthy_s=time.perf_counter() - t_kill, worker_deaths=deaths,
                  handed_off=stats["handed_off"], failovers=stats["failovers"],
                  stream_resumes=stats["stream_resumes"],
                  pids=(victim.pid, rs.services[0].pid))
    emit("worker_kill_burst", **result)
    if deaths.get("0") != 1.0 or rs.services[0] is victim or rs.services[0].pid == victim.pid:
        raise AssertionError(f"worker_kill: one death counted and a fresh worker expected: "
                             f"{result}")
    return result


def kill_stream(torch, rs, prompt: str, n_tokens: int) -> dict:
    """A greedy stream whose worker SIGKILLs itself (``kill_process`` at
    the worker's stream-chunk fault point, armed through its
    ``inject_fault`` RPC) after its first delivered piece resumes on the
    survivor with the uninterrupted run's text; one resume, the tenant
    balanced, the worker respawned."""
    from sentio_tpu_torch.runtime.worker import STREAM_CHUNK_POINT

    rs.wait_idle()
    reference = rs.generate(prompt, max_new_tokens=n_tokens, temperature=0.0, timeout_s=300)
    victim_idx = reference.replica_id
    rs.wait_idle()
    stats0 = rs.stats()
    rebuilds0 = rs.health_summary()["replicas"][victim_idx]["rebuilds"]
    victim = rs.services[victim_idx]
    victim.inject_fault(STREAM_CHUNK_POINT, kill_process=True, times=1)
    pieces = list(rs.generate_stream(prompt, max_new_tokens=n_tokens, temperature=0.0,
                                     timeout_s=300, tenant="resume"))
    text = "".join(pieces)
    stats = rs.stats()
    tenant = stats["tenants"]["per_tenant"]["resume"]
    result = {"tokens": n_tokens, "victim": victim_idx, "pieces": len(pieces),
              "stream_resumes": stats["stream_resumes"] - stats0["stream_resumes"],
              "replayed_tokens": stats["resume_replayed_tokens"]
              - stats0["resume_replayed_tokens"],
              "tenant": {k: tenant[k] for k in ("admitted", "pending")},
              "text_equal": text == reference.text, "chars": len(reference.text),
              "routing": {k: stats["routing"][k] - stats0["routing"][k]
                          for k in stats["routing"]}}
    if result["stream_resumes"] == 1:
        result["respawn_s"] = wait_healthy(rs, victim_idx, rebuilds0 + 1)
    emit("worker_kill_stream", **result)
    if not result["text_equal"] or result["stream_resumes"] != 1 or tenant["pending"] \
            or tenant["admitted"] != 2:
        raise AssertionError(f"worker_kill: the killed stream must resume once with the "
                             f"uninterrupted text and a balanced tenant: {result}")
    return result


def partition_drill(torch, rs, prompt: str, n_tokens: int, settings) -> dict:
    """The half-open partition on a socket set: once a stream delivered its
    first piece, the router's reads from its worker stall at the recv
    frame point (``faults.hit_frame``) while its writes still land. Gates:
    the partition is detected within SOCKET_PARTITION_TIMEOUT_S plus one
    status interval (and one supervisor pass); the stream resumes on the
    survivor with the uninterrupted text; the worker heals (the same pid)
    at a higher epoch; its frames of the old epoch are counted stale, none
    delivered."""
    import threading

    from sentio_tpu_torch.infra import faults

    rs.wait_idle()
    reference = rs.generate(prompt, max_new_tokens=n_tokens, temperature=0.0, timeout_s=300)
    idx = reference.replica_id
    rs.wait_idle()
    stats0 = rs.stats()
    old = rs.services[idx]
    registry = rs.registry
    stale0, epoch0, pid0 = registry.stale_frames(idx), old.epoch, old.pid
    release = threading.Event()
    point = f"transport.recv.r{idx}"
    it = rs.generate_stream(prompt, max_new_tokens=n_tokens, temperature=0.0, timeout_s=300,
                            tenant="partition")
    pieces = [next(it)]
    faults.arm(point, faults.FaultRule(stall_event=release, stall_s=120.0, times=1))
    t_arm = time.perf_counter()
    try:
        box: dict = {}

        def consume() -> None:
            try:
                box["rest"] = list(it)
            except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
                box["error"] = exc

        t = threading.Thread(target=consume, name="smoke-partition-stream", daemon=True)
        t.start()
        wait_for(lambda: old._dead, 60.0, "the partition to be detected", poll_s=0.005)
        detected_s = time.perf_counter() - t_arm
        t.join(timeout=300)
        if "error" in box or t.is_alive():
            raise AssertionError(f"partition: the stream failed: {box.get('error')!r}")
        pieces += box["rest"]
        heal_s = wait_healthy(rs, idx, 1)
    finally:
        release.set()
        faults.disarm(point)
    wait_for(lambda: registry.stale_frames(idx) > stale0, 60.0, "stale frames to be counted")
    healed = rs.services[idx]
    text = "".join(pieces)
    stats = rs.stats()
    tenant = stats["tenants"]["per_tenant"]["partition"]
    budget = (settings.serve.socket_partition_timeout_s + old.spec.status_interval_s
              + settings.serve.replica_probe_interval_s)
    result = {"replica": idx, "detected_s": detected_s, "detect_budget_s": budget,
              "heal_s": heal_s, "epochs": (epoch0, healed.epoch), "pids": (pid0, healed.pid),
              "stale_frames": registry.stale_frames(idx) - stale0,
              "stream_resumes": stats["stream_resumes"] - stats0["stream_resumes"],
              "tenant": {k: tenant[k] for k in ("admitted", "pending")},
              "text_equal": text == reference.text, "chars": len(reference.text),
              "death": old._death_reason}
    emit("replicas_2_socket_partition", **result)
    if detected_s > budget or healed.epoch <= epoch0 or healed.pid != pid0 \
            or result["stale_frames"] <= 0 or not result["text_equal"] \
            or result["stream_resumes"] != 1 or tenant["pending"]:
        raise AssertionError(f"partition drill: {result}")
    return result


def remote_worker_check(torch, dev, weights: dict, docs, ref: dict) -> dict:
    """``worker_serve`` started as its own process with its own weights
    made from the seed at ``weights``' depth, and a router dialing it (``REPLICA_WORKERS`` with a
    shared ``SOCKET_AUTH_TOKEN``): the lone greedy text equals thread
    mode's, the worker's paged launches equal its card counts."""
    import os

    from sentio_tpu_torch.ops.prompts import PromptBuilder

    settings = worker_settings(1, "socket", socket_auth_token=SOCKET_TOKEN)
    model = dataclasses.asdict(weights["llama_config"])
    prompts = PromptBuilder()
    head = prompts.static_head("retrieve", instruction=prompts.load("profile"))
    code = (
        "import sys\n"
        "from sentio_tpu_torch.config import GeneratorConfig, ServeConfig, Settings\n"
        "from sentio_tpu_torch.models.llama import LlamaConfig\n"
        "from sentio_tpu_torch.pipeline import worker_spec\n"
        "from sentio_tpu_torch.runtime.worker import worker_serve\n"
        f"settings = Settings(generator=GeneratorConfig(max_new_tokens={MAX_TOKENS}, "
        f"verifier_max_tokens={MAX_TOKENS}))\n"
        # the seed's tensors at the router's depth: an init draws the
        # layers in order, so its first layers equal the router's
        f"spec = worker_spec(settings, LlamaConfig(**{model!r}), 0, seed={SEED}, "
        f"device='cuda', warm_head={head!r}, auth_token={SOCKET_TOKEN!r}, socket=True)\n"
        "worker_serve('127.0.0.1', 0, spec, bound_cb=lambda a: print('bound', a[1], "
        "flush=True))\n")
    # the worker makes its own weights and pool on the card
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE, text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        line = proc.stdout.readline()
        if not line.startswith("bound"):
            raise AssertionError(f"remote_worker: worker_serve did not start: {line!r}")
        port = int(line.split()[1])
        settings.serve.replica_workers = f"127.0.0.1:{port}"
        t0 = time.perf_counter()
        from sentio_tpu_torch.pipeline import build_pipeline

        pipeline = build_pipeline(settings, device=dev, seed=SEED, **weights)
        try:
            build_s = time.perf_counter() - t0
            warm = pipeline.warmup()
            rs = pipeline.replica_set
            before = worker_reports(rs)
            lone = lone_greedy(rs)
            after = worker_reports(rs)
            rows = worker_deltas(before, after)
            result = {"build_s": build_s, "warmup_s": warm["seconds"],
                      "workers": rs.workers(), "lone": lone, "launches": rows,
                      "worker_memory": after[0]["worker"].get("memory"),
                      "foreign_modules": after[0]["worker"]["foreign_modules"]}
            emit("remote_worker", **result)
            check_lone("remote_worker", lone, ref)
            check_worker_launches("remote_worker", rows, rs.services[0].engine.cfg.n_layers)
            if rs.workers()[0]["pid"] != proc.pid or result["foreign_modules"]:
                raise AssertionError(f"remote_worker: not the dialed worker: {result}")
        finally:
            close_pipeline(torch, pipeline)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    return result


def worker_phases(torch, dev, weights: dict, ref: dict) -> dict:
    """replicas_2_process and worker_kill (REPLICA_MODE=process, two
    workers on the router's weights behind the HTTP server), then
    replicas_2_socket (REPLICA_MODE=socket: one round and the partition
    drill) and remote_worker; ``ref`` holds thread-mode replicas_2's round
    times and its lone greedy text."""
    docs, words = corpus(N_CHUNKS)
    out: dict = {}
    total = REPLICA_JSON_CHATS + REPLICA_SSE_CHATS
    settings = worker_settings(2, "process")
    pipeline, server, thread, warm = worker_server(torch, dev, "replicas_2_process", settings,
                                                   weights, docs)
    try:
        client = HttpClient(server.server_address[1])
        rs = pipeline.replica_set
        rounds = [worker_burst(torch, "replicas_2_process", pipeline, client, words,
                               offset=3 * total * r) for r in range(PROCESS_ROUNDS)]
        seconds = [x for r in rounds for x in r["chat_s"]]
        card_peak = warm.pop("card_peak").stop()
        lone = lone_greedy(rs)
        reports = worker_reports(rs)
        surfaces = client.json("GET", "/info")[2]["generator"]["replicas"]
        detailed = client.json("GET", "/health/detailed")[2]["components"]["workers"]
        out["replicas_2_process"] = {
            "warmup": warm, "rounds": rounds, "round_p50_s": [r["p50_s"] for r in rounds],
            "round_p95_s": [r["p95_s"] for r in rounds], "p50_s": percentile(seconds, 0.5),
            "p95_s": percentile(seconds, 0.95),
            "completed": [sum(c) for c in zip(*(r["completed"] for r in rounds))],
            "duty_cycle": [r["duty_cycle"] for r in rounds], "lone": lone,
            "worker_memory": [r["worker"].get("memory") for r in reports],
            "card_used": card_used(torch), "card_peak": card_peak,
            "worker_max_reserved": [r["worker"].get("memory", {}).get("max_reserved")
                                    for r in reports],
            "info": surfaces, "health_workers": detailed,
            "launches": {k: sum(w["launches"][k] for r in rounds for w in r["workers"])
                         for k in rounds[0]["workers"][0]["launches"]},
            "device_launches": {k: [sum(w["device_launches"].get(k, [0, 0])[s]
                                        for r in rounds for w in r["workers"])
                                    for s in (0, 1)]
                                for k in ("paged_attention",)},
            "launches_by_worker": [
                {k: sum(r["workers"][i]["launches"][k] for r in rounds)
                 for k in rounds[0]["workers"][i]["launches"]} for i in range(rs.replicas)]}
        emit("replicas_2_process_summary", thread_round_p50_s=ref["round_p50_s"],
             process_round_p50_s=out["replicas_2_process"]["round_p50_s"],
             thread_round_p95_s=ref["round_p95_s"],
             process_round_p95_s=out["replicas_2_process"]["round_p95_s"],
             round_p50_ratio=[b / a for a, b in zip(ref["round_p50_s"],
                                                    out["replicas_2_process"]["round_p50_s"])],
             **{k: out["replicas_2_process"][k] for k in ("p50_s", "p95_s", "completed",
                                                          "duty_cycle", "card_used",
                                                          "card_peak", "worker_max_reserved",
                                                          "info", "health_workers",
                                                          "launches_by_worker")},
             weights_bytes=warm["weights_bytes"])
        check_lone("replicas_2_process", lone, ref["lone"])
        if surfaces["mode"] != "process" or len(surfaces["workers"]) != 2 \
                or not detailed["healthy"]:
            raise AssertionError(f"replicas_2_process: /info or /health/detailed: {surfaces}, "
                                 f"{detailed}")
        out["worker_kill"] = {
            "burst": kill_burst(torch, pipeline, client, words, offset=3 * total * 3),
            "stream": kill_stream(torch, rs, docs[7].text[:RESUME_PROMPT_CHARS],
                                  RESUME_TOKENS_BF16)}
    finally:
        stop_server(server, thread)
        close_pipeline(torch, pipeline)
        del pipeline
    settings = worker_settings(2, "socket")
    pipeline, server, thread, warm = worker_server(torch, dev, "replicas_2_socket", settings,
                                                   weights, docs)
    try:
        client = HttpClient(server.server_address[1])
        rs = pipeline.replica_set
        burst = worker_burst(torch, "replicas_2_socket", pipeline, client, words, offset=0)
        warm["card_peak"] = warm["card_peak"].stop()
        lone = lone_greedy(rs)
        check_lone("replicas_2_socket", lone, ref["lone"])
        out["replicas_2_socket"] = {
            "warmup": warm, "round": burst, "lone": lone,
            "partition": partition_drill(torch, rs, docs[9].text[:RESUME_PROMPT_CHARS],
                                         RESUME_TOKENS_BF16, settings),
            "launches": {k: sum(w["launches"][k] for w in burst["workers"])
                         for k in burst["workers"][0]["launches"]}}
    finally:
        stop_server(server, thread)
        close_pipeline(torch, pipeline)
        del pipeline
    out["remote_worker"] = remote_worker_check(torch, dev, weights, docs, ref["lone"])
    return out


# ------------------------------------------------------------- the elastic fleet

# the elastic phase's serve settings: one socket worker at the start, the
# autoscaler's window, cooldowns and poll cut to seconds. Scale-out follows
# the backlog (a burst of ELASTIC_BURST chats over 32 queue places);
# busy, the pumps' duty since their start or their last re-base, keeps
# AUTOSCALE_OUT_BUSY at 1.0 out of scale-out's way and lets scale-in through
# only after the duty is re-based at the second join (a joined worker's
# warmup keeps the fleet's mean above AUTOSCALE_IN_BUSY until then); the
# scale-in cooldown outlasts a join by 10 s or more, so the fleet shrinks
# only in step 5
ELASTIC_SERVE = dict(
    replicas=1, replica_mode="socket", autoscale=True, autoscale_min_replicas=1,
    autoscale_max_replicas=2, autoscale_window_s=2.0, autoscale_poll_interval_s=0.25,
    autoscale_out_busy=1.0, autoscale_in_busy=0.5, autoscale_out_backlog=0.2,
    autoscale_out_cooldown_s=10.0, autoscale_in_cooldown_s=50.0, admission_max_queue=32,
    affinity_stickiness=0.0, replica_rebuild_drain_s=60.0)
ELASTIC_BURST = 16       # JSON chats released together to grow the fleet
ELASTIC_CHUNKS = 512     # the elastic server's corpus
ELASTIC_WAVE = 8         # the wave that reaches the joined worker
# a stream of 512 tokens on an 8-layer worker of the H100 ran ~3 s, as long
# as the lead, and so could end before the scale-in fired: 1,024 run about
# twice the lead, so each is still in flight when the cooldown ends
ELASTIC_STREAM_TOKENS = 1024
ELASTIC_STREAM_LEAD_S = 3.0   # the streams start this long before scale-in may fire
ELASTIC_JOIN_S = 240.0
# short prompts (less than one 128-token page): no radix hit anywhere, so a
# stream and its reference take the same prefill
ELASTIC_STREAM_PROMPTS = ("Elastic stream one: count the pages of a decode pool",
                          "Elastic stream two: name the slots of a decode batch")


def elastic_chats(client, words, n: int, offset: int, tag: str) -> tuple:
    """``n`` JSON chats released together on threads, each named
    ``{tag}-{i}`` (its flight record): the threads, and the list each
    fills with its status, body, seconds and the perf_counter at which it
    returned (:func:`finish_chats` joins them)."""
    import threading

    out: list = [None] * n
    start = threading.Barrier(n)

    def run(i: int) -> None:
        question = f"What links {words[offset + 3 * i]} to {words[offset + 3 * i + 1]}?"
        start.wait(timeout=60)
        t0 = time.perf_counter()
        try:
            status, _, body = client.json("POST", "/chat",
                                          {"question": question, "thread_id": f"{tag}-{i}"})
            out[i] = (status, body, time.perf_counter() - t0, time.perf_counter())
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            out[i] = ("raised", exc, time.perf_counter() - t0, time.perf_counter())

    threads = [threading.Thread(target=run, args=(i,), name=f"smoke-elastic-{i}", daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    return threads, out


def finish_chats(phase: str, threads: list, out: list) -> dict:
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"{phase}: a chat did not return within {HTTP_TIMEOUT_S:.0f} s")
    for i, (status, body, _s, _t) in enumerate(out):
        if status == "raised":
            raise AssertionError(f"{phase} chat {i} raised: {body!r}") from body
        check_http_chat(phase, i, status, body)
    seconds = [s for _st, _b, s, _t in out]
    return {"chat_s": seconds, "p50_s": percentile(seconds, 0.5),
            "p95_s": percentile(seconds, 0.95),
            "replicas": [b["metadata"].get("replica_id") for _st, b, _s, _t in out],
            "done_at": [t for *_x, t in out]}


def fleet_gauge(client) -> float:
    samples = parse_prometheus(client.request("GET", "/metrics")[2].decode())
    return metric_sum(samples, "sentio_tpu_fleet_live_replicas")


def decisions(client) -> dict:
    samples = parse_prometheus(client.request("GET", "/metrics")[2].decode())
    out = {"out": 0.0, "in": 0.0}
    for (name, labels), value in samples.items():
        if name == "sentio_tpu_autoscale_decisions_total":
            direction = dict(labels)["direction"]
            out[direction] = out.get(direction, 0.0) + value
    return out


def quiet_card(torch) -> int:
    """The card's used bytes with the router's cached blocks returned."""
    gc.collect()
    torch.cuda.empty_cache()
    return card_used(torch)


def gpu_processes() -> dict:
    """{pid: used bytes} of each process nvidia-smi lists on the card ({}
    where it lists none, or other pids than this machine's)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         timeout=60).stdout
    procs = {}
    for line in out.splitlines():
        parts = [x.strip() for x in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            procs[int(parts[0])] = int(parts[1]) << 20
    return procs


def card_overhead(torch, rs) -> dict:
    """The card's used bytes (the router's cache returned) and the part no
    process accounts for: with nvidia-smi's per-process bytes of the
    router and the live workers, what is left (pinned, leaked); without
    them, what the router's and the live workers' allocators do not hold
    (the contexts, the modules loaded, anything pinned). A join adds a
    worker's context to the latter; a second copy of the weights would add
    16 GB; a retire must leave neither."""
    import os

    pids = {i: svc.pid for i, svc in zip(range(rs.replicas), rs.services)
            if rs._health[i].state != "RETIRED"}
    reserved = {i: (rs.services[i].stats()["worker"].get("memory") or {}).get("reserved") or 0
                for i in pids}
    used = quiet_card(torch)
    procs = gpu_processes()
    router = torch.cuda.memory_reserved()
    mine = [os.getpid(), *pids.values()]
    by_process = all(pid in procs for pid in mine)
    overhead = (used - sum(procs[pid] for pid in mine) if by_process
                else used - router - sum(reserved.values()))
    return {"used": used, "reserved": reserved, "router_reserved": router,
            "processes": {pid: procs.get(pid) for pid in mine}, "by_process": by_process,
            "overhead": overhead}


def await_decision(scaler, direction: str, count: int, timeout_s: float) -> float:
    """The perf_counter at which the loop's ``direction`` count reached
    ``count`` (polled every 20 ms)."""
    key = "scale_out" if direction == "out" else "scale_in"
    wait_for(lambda: scaler.stats()[key] >= count, timeout_s,
             f"autoscale decision {direction} #{count}", poll_s=0.02)
    return time.perf_counter()


def await_join(torch, rs, slot: int, epoch: int, before: dict, weight_bytes: int,
               phase: str) -> dict:
    """The worker of ``slot`` joined at ``epoch`` (warmed by the membership
    source): its seconds, its reserved memory and the card's rise, gated
    to one copy of the weights, as :func:`worker_server` gates a spawn: the
    rise less the growth of every worker's allocator (the newcomer's whole
    reserve, the others' growth under the burst) is at most
    ``WORKER_SLACK_BYTES``, and the newcomer's reserve is less than the
    weights' bytes (a private copy shows in one or the other)."""
    t0 = time.perf_counter()
    wait_for(lambda: rs.live_replicas == 2 and rs.replicas > slot
             and rs.services[slot].epoch == epoch
             and rs.health_summary()["status"] == "healthy", ELASTIC_JOIN_S,
             f"{phase}: the worker of slot {slot} to join at epoch {epoch}")
    worker = rs.services[slot]
    report = worker.stats()["worker"]
    reserved = (report.get("memory") or {}).get("reserved")
    after = card_overhead(torch, rs)
    out = {"slot": slot, "epoch": worker.epoch, "pid": worker.pid,
           "waited_s": time.perf_counter() - t0, "reserved": reserved,
           "card_rise": after["used"] - before["used"],
           "overhead_rise": after["overhead"] - before["overhead"],
           "before": before, "after": after,
           "graphs_captured": report["graphs_captured"], "graphs_frozen": report["graphs_frozen"],
           "foreign_modules": report["foreign_modules"]}
    # the worker's own bytes where nvidia-smi has them (its allocator and
    # context), else the rise no allocator accounts for
    own = after["processes"].get(worker.pid) if after["by_process"] else None
    out["worker_bytes"] = own
    over = own - reserved if own is not None else out["overhead_rise"]
    if not report["graphs_frozen"] or report["foreign_modules"]:
        raise AssertionError(f"{phase}: the joined worker joined unwarmed or loaded JAX: {out}")
    # held at the phase's end, so one run reports every step's memory
    out["weights_bytes"] = weight_bytes
    out["memory_gate"] = (None if reserved and over <= WORKER_SLACK_BYTES
                          and reserved < weight_bytes else
                          f"{phase}: the joined worker is not on the shared weights: "
                          f"{over} bytes beyond its reserve of {reserved} "
                          f"({weight_bytes} weight bytes)")
    return out


def await_retired(torch, rs, slot: int, pid: int, before: dict, phase: str) -> dict:
    """``slot`` RETIRED, its registry slot released, its process gone and
    the card's overhead (:func:`card_overhead`) back within 1 GB of
    ``before``'s, taken before the join: the retired worker's pool and
    context freed, nothing left pinned."""
    import os

    from sentio_tpu_torch.runtime.replica import HEALTH_RETIRED

    t0 = time.perf_counter()
    wait_for(lambda: rs._health[slot].state == HEALTH_RETIRED, 120,
             f"{phase}: slot {slot} to retire")

    def gone():
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            return True
        # a zombie has exited: its memory is released
        try:
            with open(f"/proc/{pid}/stat") as fh:
                return fh.read().split()[2] == "Z"
        except OSError:
            return True

    wait_for(gone, 60, f"{phase}: worker pid {pid} to exit")
    deadline = time.perf_counter() + 20.0
    after = card_overhead(torch, rs)
    while after["overhead"] - before["overhead"] > 1 << 30 and time.perf_counter() < deadline:
        time.sleep(0.5)
        after = card_overhead(torch, rs)
    free = rs.registry.stats()["free_slots"]
    if slot not in free:
        raise AssertionError(f"{phase}: slot {slot} was not released: {free}")
    return {"slot": slot, "waited_s": time.perf_counter() - t0, "card_used": after["used"],
            "card_over_before": after["used"] - before["used"],
            "overhead_over_before": after["overhead"] - before["overhead"],
            "before": before, "after": after, "free_slots": free,
            # held at the phase's end
            "memory_gate": (None if after["overhead"] - before["overhead"] <= 1 << 30 else
                            f"{phase}: the card did not fall back within 1 GB of its level "
                            f"before the join")}


def redial_rejected(rs, slot: int) -> str:
    """A retired slot's redial is refused typed (FrameProtocolError)."""
    import os

    from sentio_tpu_torch.runtime.transport import FrameProtocolError, dial, send_hello

    t = dial(tuple(rs.registry.address))
    try:
        send_hello(t, rs.registry.auth_token, slot, os.getpid())
    except FrameProtocolError as exc:
        return str(exc)
    finally:
        t.close()
    raise AssertionError(f"elastic: a redial of retired slot {slot} was accepted")


def first_served(chats: dict, slot: int, since: float) -> Optional[float]:
    done = [t for r, t in zip(chats["replicas"], chats["done_at"]) if r == slot]
    return min(done) - since if done else None


def elastic_check(torch, dev, weights: dict, ref_lone: Optional[dict]) -> dict:
    """Phase 36 (see the module docstring)."""
    import threading

    from sentio_tpu_torch import __main__ as cli
    from sentio_tpu_torch.config import GeneratorConfig, ServeConfig, Settings
    from sentio_tpu_torch.infra.flight import get_flight_recorder

    t_phase = time.perf_counter()
    docs, words = corpus(ELASTIC_CHUNKS)
    settings = Settings(generator=GeneratorConfig(max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS),
                        serve=ServeConfig(**ELASTIC_SERVE))
    emit("elastic_settings", **{k.upper(): v for k, v in ELASTIC_SERVE.items()},
         burst=ELASTIC_BURST, wave=ELASTIC_WAVE, stream_tokens=ELASTIC_STREAM_TOKENS)
    pipeline, server, thread, warm = worker_server(torch, dev, "elastic", settings, weights,
                                                   docs)
    result: dict = {"warmup": warm}
    try:
        warm.pop("card_peak").stop()
        client = HttpClient(server.server_address[1])
        rs = pipeline.replica_set
        scaler = rs.autoscaler
        n_layers = rs.services[0].engine.cfg.n_layers
        gauge = [fleet_gauge(client)]
        decisions0 = decisions(client)
        stats0 = rs.stats()
        window = LaunchWindow(torch)
        # the card's level before each join: read just before the loop
        # launches a worker (the first worker's allocator grows under the
        # burst that decides it)
        levels: list = []
        launch = scaler.launcher

        def metered_launch():
            levels.append(card_overhead(torch, rs))
            launch()

        metered_launch.close = launch.close  # the set's close reaps through it
        scaler.launcher = metered_launch
        weight_bytes = tensor_bytes(weights["llama_params"])
        rows: list = []

        # 1. scale out under a burst
        before0 = worker_reports(rs)
        threads, out = elastic_chats(client, words, ELASTIC_BURST, 0, "elastic-burst1")
        t_out1 = await_decision(scaler, "out", 1, 120)
        burst1 = finish_chats("elastic_burst1", threads, out)
        join1 = await_join(torch, rs, 1, 1, levels[0], weight_bytes, "elastic_join1")
        join1["decision_to_join_s"] = time.perf_counter() - t_out1
        emit("elastic_join1", burst_p50_s=burst1["p50_s"], **join1)
        gauge.append(fleet_gauge(client))

        # 2. a wave that reaches the joined worker; its lone greedy text
        before1 = worker_reports(rs)[1]
        threads, out = elastic_chats(client, words, ELASTIC_WAVE, 3 * ELASTIC_BURST,
                                     "elastic-wave")
        wave = finish_chats("elastic_wave", threads, out)
        if 1 not in wave["replicas"]:
            raise AssertionError(f"elastic: no chat of the wave reached the joined worker: "
                                 f"{wave['replicas']}")
        served = wave["replicas"].index(1)
        # the chat's generate ran on the joined worker (its verify may have
        # run on the other: the record is stitched from the first worker in
        # slot order that holds one, as JAX's)
        status, _, record = client.json("GET", f"/debug/flight/elastic-wave-{served}")
        flight = {k: (record or {}).get(k) for k in (
            "engine_window", "engine_replica", "engine_epoch", "clock_uncertainty_s",
            "replicas_unavailable")}
        flight.update(status=status, ticks=len((record or {}).get("ticks") or []),
                      engine_keys=sorted(((record or {}).get("engine") or {})))
        emit("elastic_flight", chat=served, **flight)
        if status != 200 or flight["engine_window"] != "stitched" \
                or flight["engine_replica"] not in (0, 1) or not flight["ticks"] \
                or not flight["engine_keys"] or flight["replicas_unavailable"]:
            raise AssertionError(f"elastic: a worker-served chat's flight record is not "
                                 f"stitched: {flight}")
        rs.wait_idle()
        lone_ref = ref_lone or {"text": rs.services[0].generate(
            LONE_PROMPT, max_new_tokens=MAX_TOKENS, temperature=0.0, timeout_s=300).text}
        lone = rs.services[1].generate(LONE_PROMPT, max_new_tokens=MAX_TOKENS,
                                       temperature=0.0, timeout_s=300)
        check_lone("elastic", {"text": lone.text}, lone_ref)
        # the uninterrupted greedy runs of step 5's streams, one on each
        # worker at once (every worker holds the same weights and graphs)
        references: list = [None] * len(ELASTIC_STREAM_PROMPTS)

        def reference(i: int) -> None:
            references[i] = rs.services[i].generate(
                ELASTIC_STREAM_PROMPTS[i], max_new_tokens=ELASTIC_STREAM_TOKENS,
                temperature=0.0, timeout_s=300).text

        refs = [threading.Thread(target=reference, args=(i,), name=f"smoke-elastic-ref-{i}",
                                 daemon=True) for i in range(len(ELASTIC_STREAM_PROMPTS))]
        for t in refs:
            t.start()
        for t in refs:
            t.join(timeout=300)
        if None in references:
            raise AssertionError("elastic: a reference run did not finish")
        after = worker_reports(rs)
        rows += worker_deltas(before0[:1], after[:1]) + worker_deltas([before1], after[1:2])
        duty_wave = [svc.duty_cycle() for svc in rs.services]

        # 3. the joined worker deregisters: a graceful retire
        pid1 = rs.services[1].pid
        lanes_before = fleet_lanes_of(cli._fleet_trace(pipeline))
        rs.services[1].request_leave("elastic smoke")
        retire1 = await_retired(torch, rs, 1, pid1, levels[0], "elastic_deregister")
        retire1["redial"] = redial_rejected(rs, 1)
        if "was retired" not in retire1["redial"]:
            raise AssertionError(f"elastic: the redial's rejection: {retire1['redial']}")
        emit("elastic_deregister", wave_p50_s=wave["p50_s"], wave_replicas=wave["replicas"],
             **retire1)
        gauge.append(fleet_gauge(client))
        lanes_retired = fleet_lanes_of(cli._fleet_trace(pipeline))

        # 4. another burst: the autoscaler launches again, the slot reused
        # (past the scale-out cooldown, which a join on the card outlasts)
        time.sleep(max(t_out1 + settings.serve.autoscale_out_cooldown_s - time.perf_counter(),
                       0.0))
        before0 = worker_reports(rs)[0]
        threads, out = elastic_chats(client, words, ELASTIC_BURST, 6 * ELASTIC_BURST,
                                     "elastic-burst2")
        t_out2 = await_decision(scaler, "out", 2, 120)
        burst2 = finish_chats("elastic_burst2", threads, out)
        join2 = await_join(torch, rs, 1, 2, levels[1], weight_bytes, "elastic_join2")
        join2["decision_to_join_s"] = time.perf_counter() - t_out2
        emit("elastic_join2", burst_p50_s=burst2["p50_s"], **join2)
        gauge.append(fleet_gauge(client))
        before2 = worker_reports(rs)[1]
        # the rejoined worker's lone greedy text too (its first request)
        lone2 = rs.services[1].generate(LONE_PROMPT, max_new_tokens=MAX_TOKENS,
                                        temperature=0.0, timeout_s=300)
        first_request = time.perf_counter() - t_out2
        check_lone("elastic_rejoin", {"text": lone2.text}, lone_ref)
        after = worker_reports(rs)
        rows += worker_deltas([before0], after[:1]) + worker_deltas([before2], after[1:2])
        # the pumps' duty re-based: the idle fleet reads idle from here, and
        # the streams' share stays under AUTOSCALE_IN_BUSY while they ran
        # less long than the fleet idled before them. Without the re-base a
        # joined worker's warmup holds the cumulative duty (reported) above
        # AUTOSCALE_IN_BUSY: the scale-in gated here is the one that follows
        # a re-base, not one a fleet with cumulative duty would get
        duty_before_rebase = [svc.duty_cycle() for svc in rs.services]
        for svc in rs.services:
            svc.reset_duty_cycle()
        pid = {i: rs.services[i].pid for i in (0, 1)}

        # 5. scale-in with a stream in flight on each replica
        start_at = t_out2 + settings.serve.autoscale_in_cooldown_s - ELASTIC_STREAM_LEAD_S
        if time.perf_counter() > start_at - ELASTIC_STREAM_LEAD_S:
            raise AssertionError(f"elastic: the second join took "
                                 f"{join2['decision_to_join_s']:.1f} s, too late for the "
                                 f"scale-in cooldown ({settings.serve.autoscale_in_cooldown_s}"
                                 " s)")
        time.sleep(max(start_at - time.perf_counter(), 0.0))
        streams: list = [dict() for _ in ELASTIC_STREAM_PROMPTS]

        route = rs._route

        def consume(i: int, first: threading.Event) -> None:
            box = streams[i]
            box["stats"] = {}
            try:
                # stream i on replica i: the set routes it there (its first
                # route only; a resume routes as the set would)
                rs._route = lambda toks, count=True, exclude=frozenset(): (i, 0)
                try:
                    it = rs.generate_stream(ELASTIC_STREAM_PROMPTS[i],
                                            max_new_tokens=ELASTIC_STREAM_TOKENS,
                                            temperature=0.0, timeout_s=300,
                                            stats_out=box["stats"])
                finally:
                    rs._route = route
                pieces = [next(it)]
                first.set()
                pieces += list(it)
                box["text"] = "".join(pieces)
            except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
                box["error"] = exc
                first.set()
            box["done_at"] = time.perf_counter()

        consumers = []
        for i in range(len(ELASTIC_STREAM_PROMPTS)):
            first = threading.Event()
            consumers.append(threading.Thread(target=consume, args=(i, first),
                                              name=f"smoke-elastic-stream-{i}", daemon=True))
            consumers[-1].start()
            first.wait(timeout=120)  # in flight before the next routes
        # the retire begins (RETIRING) at the decision; the loop books the
        # decision once the drain is over
        t_in = wait_for(lambda: next((time.perf_counter() for i in (0, 1)
                                      if rs._health[i].state in ("RETIRING", "RETIRED")), None),
                        120, "the scale-in's retire to begin", poll_s=0.01)
        await_decision(scaler, "in", 1, 120)
        for t in consumers:
            t.join(timeout=300)
        if any(t.is_alive() for t in consumers) or any("error" in b for b in streams):
            raise AssertionError(f"elastic: a stream failed: {streams}")
        wait_for(lambda: rs.live_replicas == 1, 120, "the scale-in's retire")
        retired = [i for i in (0, 1) if rs._health[i].state == "RETIRED"]
        # "replica" is where a stream ended: a resume would move it off its
        # routed replica, so the retired one's stream is held to end there
        stream_rows = [{"routed": i, "replica": b["stats"].get("replica_id"),
                        "done_after_in_s": b["done_at"] - t_in, "equal": b["text"] == ref,
                        "tokens": b["stats"].get("tokens")}
                       for i, (b, ref) in enumerate(zip(streams, references))]
        on_retired = [r for r in stream_rows if r["replica"] in retired]
        if len(retired) != 1 or not on_retired or not all(r["equal"] for r in stream_rows) \
                or on_retired[0]["done_after_in_s"] <= 0:
            raise AssertionError(f"elastic: scale-in retired {retired} with streams "
                                 f"{stream_rows}, stream resumes "
                                 f"{rs.stats()['stream_resumes'] - stats0['stream_resumes']}")
        retire2 = await_retired(torch, rs, retired[0], pid[retired[0]], levels[1],
                                "elastic_scale_in")
        emit("elastic_scale_in", streams=stream_rows, **retire2)
        gauge.append(fleet_gauge(client))

        # 6. the fleet trace: a lane per incarnation, the retired ones marked
        lanes_end = fleet_lanes_of(cli._fleet_trace(pipeline))
        incarnations = {**lanes_before, **lanes_retired, **lanes_end}
        marked = [name for name in incarnations.values() if name.endswith("(retired)")]
        if len(incarnations) != 3 or len(marked) < 2:
            raise AssertionError(f"elastic: the fleet trace's lanes: {lanes_before}, "
                                 f"{lanes_retired}, {lanes_end}")

        router, router_card = window.read()
        memory_gates = [x["memory_gate"] for x in (join1, retire1, join2, retire2)
                        if x["memory_gate"]]
        check_card("elastic_router", router_card, router)
        if router["paged_attention"] or router["flash_attention"] <= 0:
            raise AssertionError(f"elastic: the router decoded, or never launched flash: "
                                 f"{router}")
        check_worker_launches("elastic", rows, n_layers)
        made = {k: v - decisions0.get(k, 0.0) for k, v in decisions(client).items()}
        if made.get("out", 0) < 2 or made.get("in", 0) < 1 or gauge != [1, 2, 1, 2, 1]:
            raise AssertionError(f"elastic: decisions {made}, fleet gauge {gauge}")
        stats = rs.stats()
        events = [t for t in get_flight_recorder().timeline()
                  if t.get("event") in ("autoscale_decision", "replica_joined")]
        result.update(
            burst1=burst1, wave=wave, burst2=burst2, joins=[join1, join2],
            retires=[retire1, retire2], flight=flight, lone_equal=lone.text == lone2.text,
            # the first chat the joined worker served after each decision
            # (after the second, its first request is a reference run)
            decision_to_first_served_s=[first_served(burst1, 1, t_out1) or
                                        first_served(wave, 1, t_out1),
                                        first_served(burst2, 1, t_out2)],
            decision_to_first_request_s=[None, first_request],
            streams=stream_rows, decisions=made, fleet_gauge=gauge,
            autoscaler=scaler.stats(), fleet=stats["fleet"],
            handed_off=stats["handed_off"] - stats0["handed_off"],
            stream_resumes=stats["stream_resumes"] - stats0["stream_resumes"],
            duty_cycle_wave=duty_wave, duty_cycle_before_rebase=duty_before_rebase,
            scale_in_conditions=(
                "after reset_duty_cycle() on every worker at the second join (the "
                "cumulative duty before it: duty_cycle_before_rebase); each stream "
                "routed by the phase to its replica"),
            fleet_lanes=incarnations,
            registry=rs.registry.stats(), router_launches=router,
            router_device_launches=router_card, worker_windows=rows,
            paged_launches=sum(r["launches"]["paged_attention"] for r in rows),
            events=[{k: e.get(k) for k in ("event", "direction", "reason", "replica")}
                    for e in events], seconds=time.perf_counter() - t_phase)
        emit("elastic", **result)
        if memory_gates:
            raise AssertionError("; ".join(memory_gates))
        return result
    finally:
        stop_server(server, thread)
        close_pipeline(torch, pipeline)


def fleet_lanes_of(trace: Optional[dict]) -> dict:
    """A fleet trace's worker lanes by pid, the clock bound cut off."""
    if trace is None:
        raise AssertionError("elastic: the fleet trace found no worker replica")
    return {e["pid"]: re.sub(r" \(clock [^)]*\)", "", e["args"]["name"])
            for e in trace["traceEvents"]
            if e.get("ph") == "M" and e["name"] == "process_name" and e["pid"] >= 1000}


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
                out["replicas_2"]["lone"] = lone_greedy(pipeline.replica_set)
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


def worker_rounds(torch, dev) -> dict:
    """The rounds of replicas_1 and replicas_2 in thread mode and in
    process mode, on one set of random weights, each after its own
    warmup: each round's p50 and the JSON chats' mean stage ms, to tell
    the process boundary's cost (one replica) from two workers sharing the
    card (two)."""
    docs, words = corpus(N_CHUNKS)
    out: dict = {}
    weights = None
    for n in (1, 2):
        phase = f"replicas_{n}"
        pipeline, server, thread, _warm = replica_server(torch, dev, phase, weights, n, docs)
        try:
            out[phase] = replica_rounds(torch, phase, pipeline,
                                        HttpClient(server.server_address[1]), words)
            weights = weights or shared_weights(pipeline)
        finally:
            stop_server(server, thread)
            close_pipeline(torch, pipeline)
        phase = f"replicas_{n}_process"
        pipeline, server, thread, _warm = worker_server(
            torch, dev, phase, worker_settings(n, "process"), weights, docs)
        try:
            client = HttpClient(server.server_address[1])
            total = REPLICA_JSON_CHATS + REPLICA_SSE_CHATS
            rounds = [worker_burst(torch, phase, pipeline, client, words, offset=3 * total * r)
                      for r in range(REPLICA_ROUNDS)]
            out[phase] = {"round_p50_s": [r["p50_s"] for r in rounds],
                          "card_peak": _warm.pop("card_peak").stop(), "rounds": rounds}
        finally:
            stop_server(server, thread)
            close_pipeline(torch, pipeline)
    emit("worker_rounds", **{phase: {"round_p50_s": x["round_p50_s"],
                                     "stage_ms": [r["stage_ms"] for r in x["rounds"]],
                                     "duty_cycle": [r["duty_cycle"] for r in x["rounds"]]}
                             for phase, x in out.items()})
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


# ------------------------------------------------------------------ MoE

# Mixtral-8x7B at full width, cut to 8 of its 32 layers: 16 fit one 80 GB
# card (46.96 GB of bf16 weights) with the pool and the encoders, 8 keep
# the whole run inside its time limit with the elastic phase (at 4 a
# near-tied expert choice flips between the kernel and plain paths and
# moe_logits differs by 0.80)
MOE_LAYERS = 8


def mixtral_config(n_layers: int = MOE_LAYERS):
    """Mixtral-8x7B's published widths (its HF config through JAX's
    ``moe_config_from_hf``, whose default capacity factor is the no-drop
    n_experts / experts_per_token = 4.0), cut to ``n_layers``."""
    from sentio_tpu_torch.models.moe import MoeConfig

    return MoeConfig(vocab_size=32_000, dim=4096, n_layers=n_layers, n_heads=32, n_kv_heads=8,
                     mlp_dim=14_336, max_len=32_768, rope_theta=1e6, norm_eps=1e-5,
                     n_experts=8, experts_per_token=2, capacity_factor=4.0)


def bench_moe_config(dtype: str = "float32"):
    """bench.py's ``moe`` geometry (1.31 B parameters, ~0.40 B active a
    token) at the no-drop capacity factor."""
    from sentio_tpu_torch.models.moe import MoeConfig

    return MoeConfig(vocab_size=32_000, dim=1024, n_layers=12, n_heads=16, n_kv_heads=8,
                     mlp_dim=4096, max_len=2048, rope_theta=500_000.0, dtype=dtype,
                     n_experts=8, experts_per_token=2, capacity_factor=4.0)


def sub_step_ms(torch, engine, iters: int = 20) -> float:
    """One decode sub-step's device time: the captured greedy sub-step
    replayed ``iters`` times between two CUDA events on the engine's
    stream, every row masked (a masked row still reads every weight: the
    expert products run over all of each expert's capacity slots)."""
    st = engine._st
    graph = engine._graphs[(True, False)][0]
    with engine.on_stream():
        st.budgets.zero_()
        st.idx.zero_()
        graph.replay()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            st.idx.zero_()
            graph.replay()
        end.record()
        end.synchronize()
        st.idx.zero_()
    return start.elapsed_time(end) / iters


def prefill_routes(torch, engine, admissions: list, iters: int = 4) -> dict:
    """moe_prefill_routes: chat 1's two admissions (the generate, then the
    verify on its prefix hit) prefilled again through the engine's
    :meth:`prefill_forward` at their widths and prior lengths, random
    tokens from the seed, the KV scattered to the scratch page and the
    prior read from it, through each expert dispatch of models/moe.py: the
    grouped rows (the default at these sizes) and the capacity buffers
    (forced). Device ms a call between CUDA events on the caller's stream
    (the grouped rows' host reads included); the two routes' last logits
    compared."""
    import numpy as np

    from sentio_tpu_torch.models import moe

    rng = np.random.default_rng(SEED)
    default_rows = moe.CAPACITY_DISPATCH_ROWS
    rows = []
    for adm in admissions:
        new, prior = adm["prefill_tokens_delta"], adm["prefix_hit_tokens_delta"]
        width = engine._prefill_width(new)
        pnb = prior // engine.page_size
        ids = rng.integers(0, engine.cfg.vocab_size, (1, width)).astype(np.int64)
        args = (ids, np.asarray([new]), np.zeros((1, width // engine.page_size), np.int64),
                np.zeros((1, pnb), np.int64) if pnb else None,
                np.asarray([prior]) if pnb else None)
        row = {"prefill_tokens": new, "prior_tokens": prior, "width": width}
        last = {}
        for route, limit in (("grouped", default_rows), ("capacity", 1 << 30)):
            moe.CAPACITY_DISPATCH_ROWS = limit
            try:
                with torch.inference_mode():
                    row[f"{route}_ms"] = time_ms(torch, lambda: engine.prefill_forward(*args),
                                                 iters=iters, warmup=1)
                    last[route] = engine.prefill_forward(*args)
            finally:
                moe.CAPACITY_DISPATCH_ROWS = default_rows
        row["logits_max_abs_diff"] = float((last["grouped"] - last["capacity"]).abs().max())
        rows.append(row)
    saved = sum(r["capacity_ms"] - r["grouped_ms"] for r in rows)
    result = {"admissions": rows, "chat_ms_saved_by_grouped": saved}
    emit("moe_prefill_routes", **result)
    return result


def moe_decode_bound(cfg, slots: int) -> dict:
    """The least time of one decode sub-step: every weight read once (the
    capacity buffers run every expert, as JAX's einsums do), against the
    products' operations at the bf16 peak."""
    d, f, e = cfg.dim, cfg.mlp_dim, cfg.n_experts
    kv = cfg.n_kv_heads * cfg.head_dim
    attn = d * (2 * d + 2 * kv) + d * e
    experts = e * 3 * d * f
    per_layer = (attn + experts) * 2
    n_bytes = cfg.n_layers * per_layer + cfg.vocab_size * d * 2
    capacity = max(1, math.ceil(slots * cfg.experts_per_token / e * cfg.capacity_factor))
    ops = (2 * cfg.n_layers * (slots * attn + e * capacity * 3 * d * f)
           + 2 * slots * d * cfg.vocab_size)
    ms, by = bound_ms(n_bytes, ops)
    return {"bound_ms": ms, "bound_by": by, "weight_bytes": n_bytes,
            "expert_bytes": cfg.n_layers * experts * 2}


def moe_phases(torch, dev) -> dict:
    """slice_moe (with moe_logits, moe_sub_step, moe_prefill_routes and
    profile_moe on its pipeline) and slice_moe_int8 on Mixtral-8x7B widths at MOE_LAYERS
    layers, random bf16 weights made on the card from the seed, the
    encoders random from the seed; then moe_exact."""
    from sentio_tpu_torch.config import GeneratorConfig, Settings
    from sentio_tpu_torch.models.moe import init_moe

    out = {}
    cfg = mixtral_config()
    t0 = time.perf_counter()
    params = init_moe(cfg, torch.Generator(device=dev).manual_seed(SEED + 13), dev)
    torch.cuda.synchronize()
    n_bytes = tensor_bytes(params)
    emit("moe_weights", seconds=time.perf_counter() - t0, bytes=n_bytes,
         config=dataclasses.asdict(cfg), card_free=torch.cuda.mem_get_info()[0])
    shared = {"llama_config": cfg, "llama_params": params}
    caps = dict(max_new_tokens=MAX_TOKENS, verifier_max_tokens=MAX_TOKENS)
    torch.cuda.reset_peak_memory_stats()
    peak = CardPeak(torch)
    sl = run_slice(torch, dev, "slice_moe", Settings(generator=GeneratorConfig(**caps)),
                   shared=shared)
    try:
        pipeline = sl["pipeline"]
        out["moe_logits"] = logits_check(torch, dev, pipeline, sl["questions"][1], "moe_logits")
        pipeline.service.wait_idle()
        engine = pipeline.generator.provider.engine
        step = {"ms": sub_step_ms(torch, engine), "slots": engine.max_slots,
                **moe_decode_bound(cfg, engine.max_slots)}
        emit("moe_sub_step", **step)
        routes = prefill_routes(torch, engine, [{k: v for k, v in c.items() if k != "prompt"}
                                                for c in sl["admissions"][:2]])
        out["profile_moe"] = profile_chat(torch, pipeline, sl["questions"][2], "profile_moe")
    finally:
        # no frame may keep the pipeline: its engine holds the weights
        pipeline = engine = None
        close_pipeline(torch, sl.pop("pipeline"))
    sl.update(sub_step=step, prefill_routes=routes, peak_memory=torch.cuda.max_memory_allocated(),
              card_peak=peak.stop())
    emit("slice_moe_memory", peak_memory=sl["peak_memory"], card_peak=sl["card_peak"],
         weight_bytes=n_bytes)
    out["slice_moe"] = sl
    sl8 = run_slice(torch, dev, "slice_moe_int8",
                    Settings(generator=GeneratorConfig(kv_quant="int8", **caps)),
                    shared=shared, n_chats=1)
    close_pipeline(torch, sl8.pop("pipeline"))
    out["slice_moe_int8"] = sl8
    del shared, params
    gc.collect()
    torch.cuda.empty_cache()
    out["moe_exact"] = moe_exact_check(torch, dev)
    return out


def plain_attention_service(**factory_kwargs):
    """A worker's service factory: :func:`default_service_factory`'s
    service with its engine on the plain decode attention (moe_exact's
    float32 pool, which the paged kernels do not take)."""
    from sentio_tpu_torch.runtime.paged import _paged_attn_xla
    from sentio_tpu_torch.runtime.worker import default_service_factory

    svc = default_service_factory(**factory_kwargs)
    svc.engine.attn_impl = _paged_attn_xla
    return svc


def moe_exact_check(torch, dev) -> dict:
    """moe_exact: bench.py's moe geometry in float32 at the no-drop capacity
    factor, plain attention (the kernels take bf16), 4 prompts of 64 tokens
    decoded SPEC_EXACT_TOKENS tokens greedily. Greedy tokens must be equal
    on the paged engine from graph replays and eagerly, on the contiguous
    engine (USE_PAGED_KV=0), under paged speculation with a 2-layer llama
    draft and contiguous speculation with a 2-layer MoE draft, and through
    a thread-mode replica's service and one REPLICA_MODE=process worker on
    the same tensors. First the geometry, cast to bf16, is written as a
    ``save_pytree`` checkpoint with meta ``"family": "moe"``, and ``python
    -m sentio_tpu_torch chat`` answers from it under LLM_CHECKPOINT in a
    process of its own while this one runs the paths above (its seconds
    are taken beside them)."""
    import os
    import threading
    from pathlib import Path

    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.models.llama import init_llama
    from sentio_tpu_torch.models.moe import init_moe
    from sentio_tpu_torch.models.tokenizer import ByteTokenizer
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla
    from sentio_tpu_torch.runtime.service import PagedGenerationService
    from sentio_tpu_torch.runtime.speculative import SpeculativeDecoder
    from sentio_tpu_torch.runtime.weights import decoder_to_jax, save_pytree
    from sentio_tpu_torch.runtime.worker import ProcessReplica, WorkerSpec

    phase = "moe_exact"
    n = SPEC_EXACT_TOKENS
    docs, _words = corpus(8)
    prompts = [d.text[:63] for d in docs[:4]]
    cfg = bench_moe_config()
    params = init_moe(cfg, torch.Generator(device=dev).manual_seed(SEED + 11), dev)
    ldcfg = bench_draft_config(cfg, n_layers=2)
    ldraft = init_llama(ldcfg, torch.Generator(device=dev).manual_seed(SEED + 12), dev)
    mdcfg = dataclasses.replace(cfg, n_layers=2)
    mdraft = init_moe(mdcfg, torch.Generator(device=dev).manual_seed(SEED + 14), dev)
    geometry = dict(max_slots=8, page_size=128, max_pages_per_seq=16, steps_per_tick=16,
                    max_tick_steps=64, pipeline_depth=2)

    def paged_engine(**kw):
        eng = ContinuousBatchingEngine(model_config=cfg, params=params, device=dev,
                                       **geometry, **kw)
        eng.attn_impl = _paged_attn_xla
        return eng

    runs, tokens = {}, {}
    counters = wrappers()
    card0 = card_launches(torch)
    for kernel in counters.values():
        kernel.launches = 0

    def record(name, results, t0, **extra):
        torch.cuda.synchronize()
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "tokens": [len(r.tokens) for r in results], **extra}
        tokens[name] = [r.tokens for r in results]

    root = Path(__file__).resolve().parent
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    cli = {}

    def cli_chat(env):
        t0 = time.perf_counter()
        cli["proc"] = subprocess.run([sys.executable, "-m", "sentio_tpu_torch", "chat",
                                      "What do the passages say about routed experts?",
                                      "--device", str(dev)], cwd=root, env=env,
                                     capture_output=True, text=True, timeout=600)
        cli["chat_s"] = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="smoke-moe-ck-") as tmp:
        t0 = time.perf_counter()
        tree = decoder_to_jax(matrices_to_bf16(torch, params))
        path = save_pytree(Path(tmp) / "moe", tree,
                           meta={"family": "moe", "config": dataclasses.asdict(bf)})
        del tree
        cli["save_s"] = time.perf_counter() - t0
        cli["checkpoint_bytes"] = sum(f.stat().st_size for f in path.iterdir())
        chat = threading.Thread(target=cli_chat, daemon=True, args=(dict(
            os.environ, LLM_CHECKPOINT=str(path), LLM_MAX_TOKENS=str(MAX_TOKENS),
            VERIFIER_MAX_TOKENS=str(MAX_TOKENS)),))
        chat.start()
        try:
            for name, graphs, draft in (("paged_graph", True, None),
                                        ("paged_eager", False, None),
                                        ("paged_spec_llama_draft", True, (ldraft, ldcfg))):
                eng = paged_engine(**({} if draft is None else dict(
                    draft_params=draft[0], draft_config=draft[1], spec_k=SPEC_K)))
                eng.cuda_graphs = graphs
                t0 = time.perf_counter()
                results = eng.run_all(prompts, max_new_tokens=n, temperature=0.0)
                record(name, results, t0, graph_replays=eng.graph_replays,
                       spec_verifies=eng.spec_verifies_total)
                del eng
            contig = GeneratorEngine(config=GeneratorConfig(max_new_tokens=n, dtype="float32"),
                                     model_config=cfg, params=params, device=dev)
            contig.attn_fn = None
            for name, gen in (("contig", contig),
                              ("contig_spec_moe_draft", SpeculativeDecoder(contig, mdraft, mdcfg,
                                                                           k=SPEC_K))):
                t0 = time.perf_counter()
                results = gen.generate(prompts, max_new_tokens=n, temperature=0.0)
                record(name, results, t0, **({"stats": gen.stats} if gen is not contig else {}))
            del contig, gen
            # a thread-mode replica's service and one worker process on these
            # tensors
            svc = PagedGenerationService(paged_engine())
            t0 = time.perf_counter()
            try:
                results = [svc.generate(p, max_new_tokens=n, temperature=0.0)
                           for p in prompts[:2]]
            finally:
                svc.close()
            record("thread_replica", results, t0)
            spec = WorkerSpec(factory="chip_smoke:plain_attention_service",
                              factory_kwargs=dict(model_family="moe",
                                                  model_config=dataclasses.asdict(cfg),
                                                  params=params, engine_kwargs=geometry,
                                                  device=str(dev)))
            t0 = time.perf_counter()
            worker = ProcessReplica(spec, ByteTokenizer(cfg.vocab_size), replica_id=0)
            spawn_s = time.perf_counter() - t0
            try:
                t0 = time.perf_counter()
                results = [worker.generate(p, max_new_tokens=n, temperature=0.0)
                           for p in prompts[:2]]
                record("process_worker", results, t0, spawn_s=spawn_s,
                       family=type(worker.engine.cfg).__name__)
            finally:
                worker.close()
                torch.cuda.ipc_collect()
        finally:
            chat.join()
    launches = {name: k.launches for name, k in counters.items()}
    card = card_delta(torch, card0)
    ref = tokens["paged_graph"]
    equal = {name: toks == ref[: len(toks)] for name, toks in tokens.items()
             if name != "paged_graph"}

    proc = cli.pop("proc", None)
    if proc is None or proc.returncode != 0:
        raise AssertionError(f"{phase}: cli chat from the moe checkpoint: "
                             + ("did not end" if proc is None else
                                f"exit {proc.returncode}: {proc.stderr[-3000:]}"))
    answer = json.loads(proc.stdout)
    cli.update(answer_chars=len(answer["answer"] or ""),
               verdict=answer["verification"].get("verdict"),
               degraded={k: answer["metadata"][k] for k in ("retrieval_error",
                                                            "generation_error")
                         if k in answer["metadata"]})
    result = {"model": dataclasses.asdict(cfg), "prompts": len(prompts), "new_tokens": n,
              "runs": runs, "tokens_equal": equal,
              "first_difference": {name: next((i for i, (a, b) in enumerate(zip(
                  tokens[name], ref)) if a != b), None) for name in equal},
              "launches": launches, "device_launches": card, "cli_chat": cli}
    emit(phase, **result)
    if not all(equal.values()):
        raise AssertionError(f"{phase}: greedy tokens differ across paths: {equal}")
    if runs["paged_graph"]["graph_replays"] <= 0 or runs["paged_eager"]["graph_replays"]:
        raise AssertionError(f"{phase}: the graph run must replay and the eager one not: "
                             f"{runs}")
    if runs["paged_spec_llama_draft"]["spec_verifies"] <= 0 \
            or runs["process_worker"]["family"] != "MoeConfig":
        raise AssertionError(f"{phase}: no spec verify, or the worker is not MoE: {runs}")
    if not cli["answer_chars"] or cli["degraded"]:
        raise AssertionError(f"{phase}: the cli chat from the moe checkpoint: {cli}")
    # plain attention throughout in this process: no kernel launched
    check_card(phase, card, launches)
    if any(launches.values()):
        raise AssertionError(f"{phase}: a kernel ran on the plain-attention paths: {launches}")
    return result


def matrices_to_bf16(torch, tree):
    """``tree`` with its matrices and expert stacks in bf16, norms kept."""
    if isinstance(tree, dict):
        return {k: matrices_to_bf16(torch, v) for k, v in tree.items()}
    return tree.to(torch.bfloat16) if tree.dim() > 1 else tree


# ----------------------------------------- phase 37: converted checkpoints

CONVERT_LAYERS = 2        # the generator's depth in convert_serve
CONVERT_CHUNKS = 512      # convert_serve's corpus
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
                r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")


def write_safetensors(path, tensors: dict) -> int:
    """``tensors`` (name → torch tensor) as one ``.safetensors`` file,
    written with the standard library: a little-endian u64 header length,
    the JSON header, the raw bytes. Returns the file's bytes."""
    import torch

    names = {torch.bfloat16: "BF16", torch.float16: "F16", torch.float32: "F32"}
    header, offset, arrays = {}, 0, []
    for name, t in tensors.items():
        t = t.detach().contiguous().cpu()
        arr = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for arr in arrays:
            f.write(memoryview(arr).cast("B"))
    return 8 + len(head) + offset


# multi-code-point keys of XLM-R's map kind: decomposed letters composed,
# looked up whole when their cluster is under 6 bytes
CHARSMAP_CLUSTER_KEYS = {"e\u0301": "\u00e9", "a\u0300": "\u00e0", "n\u0303": "\u00f1",
                         "u\u0308": "\u00fc", "\u0438\u0306": "\u0439", "\r\n": " "}


def charsmap_rules() -> dict:
    """SentencePiece's ``nmt_nfkc`` kind of map: ``NFKC`` of every code
    point it changes, ``Nmt``'s controls dropped and spaces made ' ', and
    the cluster keys."""
    import unicodedata

    rules = {}
    for cp in range(1, 0x110000):
        c = chr(cp)
        if not 0xD800 <= cp <= 0xDFFF and unicodedata.normalize("NFKC", c) != c:
            rules[c] = unicodedata.normalize("NFKC", c)
    for cp in (*range(0x1, 0x9), 0xB, *range(0xE, 0x20), 0x7F, 0x8F, 0x9F):
        rules[chr(cp)] = ""
    for cp in (0x9, 0xA, 0xC, 0xD, 0x1680, *range(0x200B, 0x2010), 0x2028, 0x2029, 0xFEFF):
        rules[chr(cp)] = " "
    return {**rules, **CHARSMAP_CLUSTER_KEYS}


def build_charsmap(rules: dict) -> bytes:
    """SentencePiece's precompiled character map of ``rules`` (key →
    replacement), as ``tokenizers``' ``Precompiled`` reads it: a
    little-endian u32 of the trie's bytes, a darts-clone double array
    packed first fit (a node's children take the first free base of the
    last 16 blocks of 256 units; bases never repeat; the array ends on a
    block), then the NUL-terminated replacements."""
    import struct

    strings, value_of = bytearray(), {}
    for rep in sorted(set(rules.values())):
        value_of[rep] = len(strings)
        strings += rep.encode() + b"\0"
    root: dict = {}
    for key, rep in rules.items():
        node = root
        for b in key.encode():
            node = node.setdefault(b, {})
        node[-1] = value_of[rep]
    units = [0] * 256
    # skip[i] == i marks a free unit; a taken one points to a later free one
    skip, bases = list(range(257)), set()
    skip[0] = 1

    def free_from(i: int) -> int:
        top = i
        while skip[top] != top:
            top = skip[top]
        while skip[i] != top:
            skip[i], i = top, skip[i]
        return top

    stack = [(root, 0)]
    while stack:
        node, pos = stack.pop()
        labels = sorted(k for k in node if k >= 0)
        slots = ([0] if -1 in node else []) + labels
        if not slots:
            continue
        p = free_from(max(1, len(units) - 4096))
        while True:
            base = p ^ slots[0]
            while (base | 0xFF) >= len(units):
                skip[len(units):] = range(len(units), len(units) + 257)
                units += [0] * 256
            if base not in bases and all(skip[base ^ c] == base ^ c for c in slots[1:]):
                break
            p = free_from(p + 1)
        bases.add(base)
        offset = pos ^ base
        if offset >= 1 << 21:
            raise ValueError("charsmap: an offset outgrows 21 bits")
        units[pos] |= offset << 10 | (1 << 8 if -1 in node else 0)
        for c in slots:
            skip[base ^ c] = (base ^ c) + 1
        if -1 in node:
            units[base] = node[-1] | 1 << 31
        for c in labels:
            units[base ^ c] = c
            stack.append((node[c], base ^ c))
    return struct.pack(f"<I{len(units)}I", 4 * len(units), *units) + bytes(strings)


def hf_llama_dir(path, cfg, params) -> int:
    """The decoder (port layout: ``weight`` [out, in], Hugging Face's) as a
    ``LlamaForCausalLM`` directory."""
    from pathlib import Path

    sd = {"model.embed_tokens.weight": params["embed_tokens"]["embedding"],
          "lm_head.weight": params["lm_head"]["weight"],
          "model.norm.weight": params["final_norm"]["scale"]}
    for i in range(cfg.n_layers):
        lp, p = params[f"layers_{i}"], f"model.layers.{i}"
        sd[f"{p}.input_layernorm.weight"] = lp["attn_norm"]["scale"]
        sd[f"{p}.post_attention_layernorm.weight"] = lp["mlp_norm"]["scale"]
        for ours, theirs in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj"),
                             ("wo", "o_proj")):
            sd[f"{p}.self_attn.{theirs}.weight"] = lp["attn"][ours]["weight"]
        for ours, theirs in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                             ("w_down", "down_proj")):
            sd[f"{p}.mlp.{theirs}.weight"] = lp["mlp"][ours]["weight"]
    Path(path).mkdir(parents=True, exist_ok=True)
    (Path(path) / "config.json").write_text(json.dumps({
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
        "intermediate_size": cfg.mlp_dim, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads, "num_key_value_heads": cfg.n_kv_heads,
        "max_position_embeddings": cfg.max_len, "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.norm_eps, "tie_word_embeddings": False,
        "bos_token_id": 128000, "eos_token_id": 128001, "torch_dtype": "bfloat16"}))
    return write_safetensors(Path(path) / "model.safetensors", sd)


def hf_encoder_sd(params, cfg, prefix: str, offset_rows: int) -> dict:
    """An encoder tree in Hugging Face's BERT / XLM-R names under
    ``prefix``; ``offset_rows`` zero rows in front of the position table."""
    import torch

    pos = params["embed_positions"]["embedding"]
    if offset_rows:
        pos = torch.cat([torch.zeros(offset_rows, pos.shape[1], dtype=pos.dtype,
                                     device=pos.device), pos])
    e = f"{prefix}embeddings."
    sd = {f"{e}word_embeddings.weight": params["embed_tokens"]["embedding"],
          f"{e}position_embeddings.weight": pos,
          f"{e}token_type_embeddings.weight": params["embed_types"]["embedding"],
          f"{e}LayerNorm.weight": params["embed_norm"]["scale"],
          f"{e}LayerNorm.bias": params["embed_norm"]["bias"]}
    for i in range(cfg.n_layers):
        lp, p = params[f"layers_{i}"], f"{prefix}encoder.layer.{i}"
        for ours, theirs in (("wq", "attention.self.query"), ("wk", "attention.self.key"),
                             ("wv", "attention.self.value"), ("wo", "attention.output.dense")):
            sd[f"{p}.{theirs}.weight"] = lp["attn"][ours]["weight"]
            sd[f"{p}.{theirs}.bias"] = lp["attn"][ours]["bias"]
        for ours, theirs in (("w_in", "intermediate.dense"), ("w_out", "output.dense")):
            sd[f"{p}.{theirs}.weight"] = lp["mlp"][ours]["weight"]
            sd[f"{p}.{theirs}.bias"] = lp["mlp"][ours]["bias"]
        for ours, theirs in (("attn_norm", "attention.output.LayerNorm"),
                             ("mlp_norm", "output.LayerNorm")):
            sd[f"{p}.{theirs}.weight"] = lp[ours]["scale"]
            sd[f"{p}.{theirs}.bias"] = lp[ours]["bias"]
    return sd


def hf_encoder_config(cfg, model_type: str, offset_rows: int, pad: int, **extra) -> dict:
    return {"model_type": model_type, "vocab_size": cfg.vocab_size, "hidden_size": cfg.dim,
            "num_hidden_layers": cfg.n_layers, "num_attention_heads": cfg.n_heads,
            "intermediate_size": cfg.mlp_dim,
            "max_position_embeddings": cfg.max_len + offset_rows,
            "type_vocab_size": cfg.n_types, "pad_token_id": pad, "torch_dtype": "bfloat16",
            **extra}


def write_hf_encoders(root, weights: dict) -> dict:
    """The embedder as ``xlm-roberta`` (two offset rows before its position
    table) and the cross-encoder as ``bert`` with the head its tree maps to
    (``classifier``, and ``bert.pooler.dense`` when it has a pooler)."""
    from pathlib import Path

    out = {}
    ecfg, ccfg = weights["embedder_config"], weights["reranker_config"]
    d = Path(root) / "hf_encoder"
    d.mkdir(parents=True)
    (d / "config.json").write_text(json.dumps(hf_encoder_config(
        ecfg, "xlm-roberta", 2, 1, architectures=["XLMRobertaModel"])))
    out["encoder"] = write_safetensors(d / "model.safetensors", hf_encoder_sd(
        weights["embedder_params"], ecfg, "", 2))
    ce = weights["reranker_params"]
    d = Path(root) / "hf_cross_encoder"
    d.mkdir(parents=True)
    sd = hf_encoder_sd(ce["encoder"], ccfg, "bert.", 0)
    if "pooler" in ce:
        sd["bert.pooler.dense.weight"] = ce["pooler"]["weight"]
        sd["bert.pooler.dense.bias"] = ce["pooler"]["bias"]
    sd["classifier.weight"] = ce["head"]["weight"]
    sd["classifier.bias"] = ce["head"]["bias"]
    (d / "config.json").write_text(json.dumps(hf_encoder_config(
        ccfg, "bert", 0, 0, architectures=["BertForSequenceClassification"], num_labels=1)))
    out["cross-encoder"] = write_safetensors(d / "model.safetensors", sd)
    return out


def _bytes_to_unicode() -> list:
    """GPT-2's printable stand-in for every byte, by byte."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    table = dict(zip(bs, cs))
    return [chr(table[b]) for b in range(256)]


def llama3_specials() -> list:
    """Llama-3's 256 special tokens, ids 128,000–128,255 in order."""
    named = {0: "<|begin_of_text|>", 1: "<|end_of_text|>", 6: "<|start_header_id|>",
             7: "<|end_header_id|>", 9: "<|eot_id|>"}
    out, reserved = [], 0
    for i in range(256):
        if i in named:
            out.append(named[i])
        else:
            out.append(f"<|reserved_special_token_{reserved}|>")
            reserved += 1
    return out


def _added(tokens: list, start: int, special: bool = True) -> list:
    return [{"id": start + i, "content": t, "single_word": False, "lstrip": False,
             "rstrip": False, "normalized": False, "special": special}
            for i, t in enumerate(tokens)]


def _write_tokenizer(path, spec: dict, config: dict) -> None:
    from pathlib import Path

    Path(path).mkdir(parents=True, exist_ok=True)
    (Path(path) / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    (Path(path) / "tokenizer_config.json").write_text(json.dumps(config))


def write_llama3_tokenizer(path, n_bpe: int = 128_000) -> None:
    """A byte-level BPE with Llama-3's pre-tokenizer filling the model's
    128,256 ids: the 256 byte symbols, every pair of them, then pair +
    symbol (printable bytes first) up to ``n_bpe`` tokens, merges in that
    order; Llama-3's 256 specials after them. Synthetic merges: every id
    decodes to bytes, so a random model's answer is never empty."""
    sym = _bytes_to_unicode()
    import itertools

    order = sorted(range(256), key=lambda b: (not (32 <= b < 127), b))
    vocab = {sym[b]: b for b in range(256)}
    merges = []
    pairs = ((sym[a], sym[b]) for a in order for b in order)
    triples = ((sym[a] + sym[b], sym[c]) for a in order for b in order for c in order)
    for left, right in itertools.chain(pairs, triples):
        if len(vocab) >= n_bpe:
            break
        vocab[left + right] = len(vocab)
        merges.append([left, right])
    specials = llama3_specials()
    _write_tokenizer(path, {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(specials, n_bpe), "normalizer": None,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": LLAMA3_SPLIT}, "behavior": "Isolated",
             "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True,
             "use_regex": False}]},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True,
                    "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": True,
                  "vocab": vocab, "merges": merges}},
        {"bos_token": specials[0], "eos_token": specials[1],
         "clean_up_tokenization_spaces": False, "tokenizer_class": "PreTrainedTokenizerFast"})


def write_unigram_tokenizer(path, words) -> dict:
    """XLM-R's layout: ``Sequence[Precompiled(charsmap), Replace(" {2,}" →
    " ")]`` (the map of :func:`charsmap_rules`, built here), a Unigram of
    ``▁``-prefixed corpus words and single characters, ``Metaspace``, the
    specials ``<s>``, ``<pad>``, ``</s>``, ``<unk>`` at 0–3. Returns the
    map's bytes and build seconds."""
    import base64
    import string

    t0 = time.perf_counter()
    blob = build_charsmap(charsmap_rules())
    build_s = time.perf_counter() - t0

    specials = ["<s>", "<pad>", "</s>", "<unk>"]
    pieces = [[t, 0.0] for t in specials]
    pieces += [["▁" + w, -5.0 - 0.1 * len(w)] for w in words]
    pieces += [[c, -12.0] for c in ["▁", *string.printable.strip()]]
    pieces += [["▁" + c, -11.0] for c in string.ascii_letters + string.digits]
    meta = {"replacement": "▁", "prepend_scheme": "always", "split": True}
    _write_tokenizer(path, {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(specials, 0),
        "normalizer": {"type": "Sequence", "normalizers": [
            {"type": "Precompiled", "precompiled_charsmap": base64.b64encode(blob).decode()},
            {"type": "Replace", "pattern": {"Regex": " {2,}"}, "content": " "}]},
        "pre_tokenizer": {"type": "Metaspace", **meta}, "post_processor": None,
        "decoder": {"type": "Metaspace", **meta},
        "model": {"type": "Unigram", "unk_id": 3, "vocab": pieces, "byte_fallback": False}},
        {"bos_token": "<s>", "eos_token": "</s>", "pad_token": "<pad>", "unk_token": "<unk>",
         "cls_token": "<s>", "sep_token": "</s>", "clean_up_tokenization_spaces": False,
         "tokenizer_class": "PreTrainedTokenizerFast"})
    return {"charsmap_bytes": len(blob), "charsmap_build_s": build_s}


def write_wordpiece_tokenizer(path, words, limit: int = 512) -> None:
    """BERT's layout: ``BertNormalizer``, ``BertPreTokenizer``, a
    ``WordPiece`` of at most ``limit`` entries (the specials, characters and
    their ``##`` forms, then the corpus's words)."""
    import string

    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = string.ascii_lowercase + string.digits + string.punctuation
    entries = [*specials, *chars, *("##" + c for c in string.ascii_lowercase + string.digits)]
    entries += [w for w in words if w not in entries][: limit - len(entries)]
    _write_tokenizer(path, {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": _added(specials, 0),
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None, "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"}, "post_processor": None,
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]", "continuing_subword_prefix": "##",
                  "max_input_chars_per_word": 100,
                  "vocab": {t: i for i, t in enumerate(entries)}}},
        {"pad_token": "[PAD]", "unk_token": "[UNK]", "cls_token": "[CLS]", "sep_token": "[SEP]",
         "mask_token": "[MASK]", "clean_up_tokenization_spaces": False})


def tree_mismatches(loaded: dict, source: dict, prefix: str = "") -> list:
    """Leaves of ``loaded`` that are not bit-equal to ``source``'s (the
    same dtype, shape and bits); keys of either that the other lacks."""
    import torch

    bad = [f"{prefix}{k}: missing" for k in set(source) ^ set(loaded)]
    for key in set(source) & set(loaded):
        a, b = loaded[key], source[key]
        if isinstance(a, dict):
            bad += tree_mismatches(a, b, f"{prefix}{key}.")
        elif a.dtype != b.dtype or a.shape != b.shape or not torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b):
            bad.append(f"{prefix}{key}: {a.dtype} {tuple(a.shape)} vs {b.dtype} "
                       f"{tuple(b.shape)}")
    return bad


def dir_bytes(path) -> int:
    from pathlib import Path

    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def convert_serve_check(torch, dev, weights: dict) -> dict:
    """Phase 37: Hugging Face directories written from the card's tensors
    (the generator cut to ``CONVERT_LAYERS``), their tokenizers written with
    ``json``, ``python -m sentio_tpu_torch convert`` for each family, then
    ``build_pipeline(Settings.from_env())`` with the six checkpoint and
    tokenizer settings. See the module's docstring for the gates."""
    import os
    import shutil
    import threading
    from pathlib import Path

    from sentio_tpu_torch.config import Settings
    from sentio_tpu_torch.models.tokenizer import HFTokenizer
    from sentio_tpu_torch.pipeline import build_pipeline
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine

    phase = "convert_serve"
    t_phase = time.perf_counter()
    root = Path(tempfile.mkdtemp(prefix="smoke-convert-"))
    cut = cut_depth(weights, CONVERT_LAYERS)
    docs, words = corpus(CONVERT_CHUNKS)
    result: dict = {}
    env_keys = ("LLM_CHECKPOINT", "LLM_TOKENIZER", "EMBEDDER_CHECKPOINT", "EMBEDDER_TOKENIZER",
                "RERANKER_CHECKPOINT", "RERANKER_TOKENIZER", "LLM_MAX_TOKENS",
                "VERIFIER_MAX_TOKENS")
    saved_env = {k: os.environ.get(k) for k in env_keys}
    pipeline = None
    try:
        # ---- the Hugging Face directories and the tokenizers
        t0 = time.perf_counter()
        hf_bytes = {"llama": hf_llama_dir(root / "hf_llama", cut["llama_config"],
                                          cut["llama_params"]),
                    **write_hf_encoders(root, weights)}
        hf_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = {"llama": root / "tok_llama", "encoder": root / "tok_encoder",
                "cross-encoder": root / "tok_cross_encoder"}
        write_llama3_tokenizer(toks["llama"])
        result["charsmap"] = write_unigram_tokenizer(toks["encoder"], words)
        write_wordpiece_tokenizer(toks["cross-encoder"], words)
        tok_s = time.perf_counter() - t0
        emit(f"{phase}_hf", seconds=hf_s, bytes=hf_bytes, tokenizer_seconds=tok_s,
             tokenizer_bytes={k: dir_bytes(v) for k, v in toks.items()}, **result["charsmap"])

        # ---- convert, each family in its own process, all at once
        srcs = {"llama": root / "hf_llama", "encoder": root / "hf_encoder",
                "cross-encoder": root / "hf_cross_encoder"}
        cks = {family: root / f"ck_{family}" for family in srcs}
        here = Path(__file__).resolve().parent
        t0 = time.perf_counter()
        procs = {family: (subprocess.Popen(
            [sys.executable, "-m", "sentio_tpu_torch", "convert", family, str(srcs[family]),
             str(cks[family])], cwd=here, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True), time.perf_counter()) for family in srcs}
        finished: dict = {}

        def wait(family: str, proc, started: float) -> None:
            out, err = proc.communicate(timeout=600)
            finished[family] = (proc, out, err, time.perf_counter() - started)

        waiters = [threading.Thread(target=wait, args=(family, *procs[family]),
                                    name=f"smoke-convert-{family}", daemon=True)
                   for family in procs]
        for waiter in waiters:
            waiter.start()
        for waiter in waiters:
            waiter.join(timeout=660)
        convert = {}
        for family, (proc, _started) in procs.items():
            if family not in finished:
                proc.kill()
                raise AssertionError(f"{phase}: convert {family} did not finish in 600 s")
            proc, out, err, seconds = finished[family]
            if proc.returncode != 0:
                raise AssertionError(f"{phase}: convert {family}: exit {proc.returncode}: "
                                     f"{err[-3000:]}")
            line = json.loads(out.strip().splitlines()[-1])
            convert[family] = {"seconds": seconds, "bytes": dir_bytes(cks[family]),
                               "config": line["config"]}
        result["convert"] = convert
        result["convert_wall_s"] = time.perf_counter() - t0
        emit(f"{phase}_convert", wall_seconds=result["convert_wall_s"], families=convert)
        for family, live in (("llama", cut["llama_config"]),
                             ("encoder", weights["embedder_config"]),
                             ("cross-encoder", weights["reranker_config"])):
            if convert[family]["config"] != live.__dict__:
                raise AssertionError(f"{phase}: {family}'s converted config "
                                     f"{convert[family]['config']} is not {live.__dict__}")
        shutil.rmtree(root / "hf_llama")
        for family in ("encoder", "cross-encoder"):
            shutil.rmtree(srcs[family])

        # ---- the pipeline from the environment's six settings
        os.environ.update({
            "LLM_CHECKPOINT": str(cks["llama"]), "LLM_TOKENIZER": str(toks["llama"]),
            "EMBEDDER_CHECKPOINT": str(cks["encoder"]),
            "EMBEDDER_TOKENIZER": str(toks["encoder"]),
            "RERANKER_CHECKPOINT": str(cks["cross-encoder"]),
            "RERANKER_TOKENIZER": str(toks["cross-encoder"]),
            "LLM_MAX_TOKENS": str(MAX_TOKENS), "VERIFIER_MAX_TOKENS": str(MAX_TOKENS)})
        settings = Settings.from_env()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pipeline = build_pipeline(settings, device=dev, seed=SEED)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        engine, emb, ce = pipeline.engine, pipeline.embedder, pipeline.reranker
        tok = engine.tokenizer
        mismatched = (tree_mismatches(engine.params, cut["llama_params"], "llama.")
                      + tree_mismatches(emb.params, weights["embedder_params"], "encoder.")
                      + tree_mismatches(ce.params, weights["reranker_params"],
                                        "cross_encoder."))
        result["load"] = {"seconds": load_s, "memory_added": torch.cuda.memory_allocated()
                          - mem0, "tokenizers": {
                              name: {"class": type(t).__name__, "vocab_size": t.vocab_size,
                                     "bos": t.bos_id, "eos": t.eos_id, "pad": t.pad_id}
                              for name, t in (("llama", tok), ("encoder", emb.tokenizer),
                                              ("cross-encoder", ce.tokenizer))},
                          "mismatched_leaves": mismatched[:20]}
        emit(f"{phase}_load", **result["load"])
        if mismatched:
            raise AssertionError(f"{phase}: converted leaves differ from their sources: "
                                 f"{mismatched[:20]}")
        if not all(isinstance(t, HFTokenizer) for t in (tok, emb.tokenizer, ce.tokenizer)) \
                or pipeline.replica_set.tokenizer is not tok:
            raise AssertionError(f"{phase}: a component does not use its checkpoint's "
                                 f"tokenizer: {result['load']['tokenizers']}")
        t0 = time.perf_counter()
        warm = pipeline.warmup()
        torch.cuda.synchronize()
        emit(f"{phase}_warmup", wall_seconds=time.perf_counter() - t0, **warm)
        # the embedder reads XLM-R's normalizer: the map's NFKC and the
        # collapsed spaces reach its ids
        etok = emb.tokenizer
        normalized = etok.encode("\ufb01ne  caf\u0065\u0301 \u2460") == etok.encode(
            "fine caf\u00e9 1")
        if not normalized:
            raise AssertionError(f"{phase}: the embedder's tokenizer does not apply the "
                                 "Precompiled map and the Replace of its normalizer")
        encode, spent = etok.encode, [0.0]

        def timed_encode(*args, **kwargs):
            t = time.perf_counter()
            try:
                return encode(*args, **kwargs)
            finally:
                spent[0] += time.perf_counter() - t

        etok.encode = timed_encode
        t0 = time.perf_counter()
        try:
            pipeline.ingest(docs)
        finally:
            del etok.encode
        torch.cuda.synchronize()
        result["ingest"] = {"chunks": len(docs), "seconds": time.perf_counter() - t0,
                            "tokenize_seconds": spent[0]}
        emit(f"{phase}_ingest", **result["ingest"])

        # ---- 3 chats in a counted window
        questions = slice_questions(docs, words)
        calls = record_admissions(pipeline.service)
        pipeline.service.wait_idle()
        sub_steps0, captures0 = engine.total_sub_steps, engine.graph_captures
        fwd0 = (emb.forwards, ce.forwards)
        try:
            window = chat_window(torch, pipeline, questions)
        finally:
            del pipeline.service.generate
        pipeline.service.wait_idle()
        launches, card = window["launches"], window["card"]
        sub_steps = engine.total_sub_steps - sub_steps0
        forwards = {"embedder": emb.forwards - fwd0[0], "cross_encoder": ce.forwards - fwd0[1]}
        predicted_flash = (forwards["embedder"] * emb.model_config.n_layers
                           + forwards["cross_encoder"] * ce.model_config.n_layers)
        prompts = [c["prompt"] for c in calls]
        round_trips = sum(tok.decode(tok.encode(p)) == p for p in questions + prompts)
        chats = []
        for i, (response, seconds) in enumerate(window["chats"]):
            check_answered(phase, i, response)
            chats.append({"seconds": seconds, "answer_chars": len(response["answer"]),
                          "generated_tokens": response["metadata"]["generated_tokens"],
                          "verdict": response["verification"].get("verdict")})
        result["chats"] = {
            "chats": chats, "seconds": window["seconds"], "launches": launches,
            "device_launches": card, "decode_sub_steps": sub_steps, "forwards": forwards,
            "predicted_flash": predicted_flash,
            "verify_radix_hits": [c["prefix_hit_tokens"] for c in calls[1::2]],
            "generate_prompt_tokens": [c["prompt_tokens"] for c in calls[::2]],
            "prompts_round_tripped": round_trips, "prompts": len(questions) + len(prompts),
            "graph_captures_delta": engine.graph_captures - captures0,
            "peak_memory": torch.cuda.max_memory_allocated()}
        emit(f"{phase}_chats", **result["chats"])
        if round_trips != len(questions) + len(prompts):
            raise AssertionError(f"{phase}: the generator's tokenizer does not round-trip "
                                 f"the chats' prompts ({round_trips} of "
                                 f"{len(questions) + len(prompts)})")
        if launches["paged_attention"] != CONVERT_LAYERS * sub_steps or sub_steps <= 0 \
                or launches["paged_attention_quant"]:
            raise AssertionError(f"{phase}: decode launches are not one bf16 paged launch "
                                 f"per layer per sub-step: {launches}, {sub_steps} sub-steps")
        if launches["flash_attention"] != predicted_flash or predicted_flash <= 0:
            raise AssertionError(f"{phase}: {launches['flash_attention']} flash launches, the "
                                 f"embedder's and cross-encoder's forwards predict "
                                 f"{predicted_flash}: {forwards}")
        check_card(phase, card, launches)
        if result["chats"]["graph_captures_delta"]:
            raise AssertionError(f"{phase}: a graph was captured after warmup")

        # ---- greedy tokens: the converted weights against the in-memory
        # tensors, one tokenizer object, fresh engines of one geometry
        prompt = questions[1]
        geometry = dict(max_slots=2, page_size=settings.generator.kv_page_size,
                        max_pages_per_seq=8, prefix_cache=False, device=dev, tokenizer=tok)
        runs = {}
        for name, (cfg, params) in (("converted", (engine.cfg, engine.params)),
                                    ("in_memory", (cut["llama_config"], cut["llama_params"]))):
            probe = ContinuousBatchingEngine(model_config=cfg, params=params, **geometry)
            runs[name] = probe.run_all([prompt], max_new_tokens=MAX_TOKENS, temperature=0.0)[0]
            del probe
        got, want = runs["converted"], runs["in_memory"]
        result["greedy"] = {"tokens": len(got.tokens), "equal": got.tokens == want.tokens,
                            "text_is_decode": got.text == tok.decode(got.tokens),
                            "text_chars": len(got.text)}
        emit(f"{phase}_greedy", **result["greedy"])
        if got.tokens != want.tokens or not got.tokens:
            raise AssertionError(f"{phase}: the converted engine's greedy tokens differ from "
                                 f"the in-memory engine's: {got.tokens} vs {want.tokens}")
        if got.text != tok.decode(got.tokens):
            raise AssertionError(f"{phase}: the answer is not the tokenizer's decode of its "
                                 "tokens")
    finally:
        if pipeline is not None:
            close_pipeline(torch, pipeline)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        shutil.rmtree(root, ignore_errors=True)
    result["providers"] = provider_settings_check(torch, dev, docs[:64], words)
    result["seconds"] = time.perf_counter() - t_phase
    emit(phase, seconds=result["seconds"], launches=result["chats"]["launches"],
         charsmap_bytes=result["charsmap"]["charsmap_bytes"],
         charsmap_build_s=result["charsmap"]["charsmap_build_s"],
         ingest_tokenize_s=result["ingest"]["tokenize_seconds"])
    return result


def provider_settings_check(torch, dev, docs, words) -> dict:
    """EMBEDDER_PROVIDER=hash, RERANKER_KIND=passthrough and
    LLM_PROVIDER=openai against the port's MockModelServer on 127.0.0.1:
    the build adds nothing to the card's allocated memory, and two chats
    are answered with no launch of any kernel, the card's counts zero."""
    from sentio_tpu_torch.config import (
        EmbedderConfig,
        GeneratorConfig,
        RerankConfig,
        Settings,
    )
    from sentio_tpu_torch.eval.baseline import MockModelServer
    from sentio_tpu_torch.pipeline import build_pipeline

    phase = "provider_settings"
    mock = MockModelServer(dim=1024).start()
    pipeline = None
    try:
        settings = Settings(embedder=EmbedderConfig(provider="hash"),
                            rerank=RerankConfig(kind="passthrough"),
                            generator=GeneratorConfig(provider="openai",
                                                      api_base=mock.base_url + "/v1",
                                                      max_new_tokens=MAX_TOKENS))
        gc.collect()
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        pipeline = build_pipeline(settings, device=dev, seed=SEED)
        torch.cuda.synchronize()
        grown = torch.cuda.memory_allocated() - mem0
        pipeline.ingest(docs)
        window = chat_window(torch, pipeline, [
            f"What does the corpus say about {words[7]}?", docs[3].text[:200]])
        for i, (response, _s) in enumerate(window["chats"]):
            check_answered(phase, i, response)
        result = {"memory_grown_by_build": grown, "engine": pipeline.engine is not None,
                  "launches": window["launches"], "device_launches": window["card"],
                  "mock_calls": dict(mock.calls), "seconds": window["seconds"],
                  "answers": [r["answer"][:80] for r, _ in window["chats"]]}
        emit(phase, **result)
        if grown > 0 or result["engine"]:
            raise AssertionError(f"{phase}: the build put something of the generator on the "
                                 f"card ({grown} bytes, engine {result['engine']})")
        if any(window["launches"].values()) or any(window["card"].values()) \
                or mock.calls.get("chat", 0) < 2:
            raise AssertionError(f"{phase}: kernels ran, or the endpoint was not asked: "
                                 f"{result}")
        return result
    finally:
        if pipeline is not None:
            pipeline.close()
        mock.stop()


# mesh_tp: tensor parallelism over two coordinates of the one card
MESH_TP = 2
# the tp=1 / tp=2 logits engines' depth, bf16 and int8 (4: cut from the
# slice's 32 and 8 to make room for mesh_tp)
MESH_PARITY_LAYERS = 4
MESH_INDEX_SHARDS = 4
# the sharded index's scores against the unsharded one's: float32 products
# in another reduction order; bf16 one rounding step of a score below 1
INDEX_SCORE_LIMIT = {"float32": 1e-5, "bfloat16": 2 ** -8}
# a tp=2 shard of Llama-3-8B's decode: (B, H, Hkv, D, page, pages a row)
TP2_GEOMETRY = (8, 32 // MESH_TP, 8 // MESH_TP, 128, 128, 64)


def tp2_kernel_cases(torch, dev, sweep: dict, sweep_quant: dict) -> dict:
    """Each kernel at the shape one tp=2 shard gives it on mesh_tp's main
    path: both paged kernels at a chat's decode (H 16, Hkv 4), the flash
    kernel at the base embedder's ingest batch (H 8, D 64) and at the
    contiguous engine's 8B prefill (H 16, D 128); held to the plain
    versions and timed as the full-width cases are."""
    rng = torch.Generator().manual_seed(SEED + 1)
    emb_lens = [0, 512, 1, 64] + torch.randint(0, 513, (124,), generator=rng).tolist()
    shape = "b8_h16_hkv4_d128_page128"
    return {
        "paged_attention": paged_check(torch, dev, sweep, f"tp2_chat_decode_{shape}",
                                       CHAT_LENS, geometry=TP2_GEOMETRY),
        "paged_attention_quant": paged_check(torch, dev, sweep_quant,
                                             f"tp2_chat_decode_int8_{shape}", CHAT_LENS,
                                             quant=True, geometry=TP2_GEOMETRY),
        "flash_attention": [
            flash_case(torch, dev, "tp2_embedder_b128_t512_h8_d64_bidirectional",
                       128, 512, 16 // MESH_TP, 64, False, emb_lens),
            prefill_flash_case(torch, dev, "tp2_llama8b_prefill_b1_t4096_s8192_h16_d128_causal",
                               1, 4096, 8192, 32 // MESH_TP, 128)],
    }


def shard_bytes(tree, seen: set) -> tuple[int, int]:
    """(bytes of ``tree``'s tensors, of those not already in ``seen``,
    whose storages it adds): what a shard holds and what it added."""
    total = fresh = 0
    for leaf in (tree.values() if isinstance(tree, dict) else [tree]):
        if isinstance(leaf, dict):
            t, f = shard_bytes(leaf, seen)
            total, fresh = total + t, fresh + f
            continue
        n = leaf.numel() * leaf.element_size()
        total += n
        ptr = leaf.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            fresh += n
    return total, fresh


def tp_logits(torch, dev, engines: dict, prompt: str, phase: str, kernel: str) -> dict:
    """One prompt's prefill and 4 teacher-forced decode steps (the forced
    tokens the first engine's greedy picks) through each engine's kernel
    path; every logit row of the tp engine against the tp=1 engine's.
    Launches of ``kernel`` by the tp engine's decode steps are counted
    (once per layer per shard per step) and held to the card's."""
    import numpy as np

    rows, forced = {}, []
    counted = {}
    for name, engine in engines.items():
        ids = engine.tokenizer.encode(prompt, add_bos=True)[: engine.max_pages_per_seq *
                                                             engine.page_size - 8]
        width = engine._prefill_width(len(ids))
        n_pages = width // engine.page_size
        if n_pages > engine.allocator.free_pages and engine._radix is not None:
            engine._radix.evict(n_pages - engine.allocator.free_pages)
        pages = engine.allocator.alloc(n_pages)
        table = torch.zeros((1, engine.max_pages_per_seq), dtype=torch.int32)
        table[0, :n_pages] = torch.tensor(pages, dtype=torch.int32)
        id_arr = np.full((1, width), engine.tokenizer.pad_id, np.int64)
        id_arr[0, : len(ids)] = ids
        try:
            with torch.inference_mode():
                steps = [engine.prefill_forward(id_arr, np.asarray([len(ids)]),
                                                table.numpy().astype(np.int64)[:, :n_pages])]
                card0 = card_launches(torch)
                for counter in wrappers().values():
                    counter.launches = 0
                for s in range(4):
                    if len(forced) <= s:
                        forced.append(int(steps[-1].argmax(-1)[0]))
                    tok = torch.tensor([forced[s]], device=dev)
                    lens = torch.tensor([len(ids) + s], dtype=torch.int32, device=dev)
                    steps.append(engine.decode_forward(tok, lens, table.to(dev)))
                counted[name] = ({k: c.launches for k, c in wrappers().items()},
                                 card_delta(torch, card0))
        finally:
            engine.allocator.free(pages)
        rows[name] = torch.stack([x[0] for x in steps]).float()
    (ref_name, ref), (tp_name, got) = rows.items()
    diff = (got - ref).abs().amax(dim=-1).tolist()
    agree = (got.argmax(-1) == ref.argmax(-1)).tolist()
    tp_engine = engines[tp_name]
    want = tp_engine.cfg.n_layers * tp_engine.tp * 4
    all_launches, card = counted[tp_name]
    launches = all_launches[kernel]
    result = {"engines": list(rows), "prompt_tokens": len(ids), "layers": tp_engine.cfg.n_layers,
              "max_abs_diff_per_step": diff, "greedy_agree": agree,
              "logit_std": float(ref.std()), f"{kernel}_launches": launches,
              "expected_launches": want, "device_launches": card}
    emit(phase, **result)
    if not bool(torch.isfinite(got).all()) or max(diff) > LOGITS_LIMIT:
        raise AssertionError(f"{phase}: tp={tp_engine.tp} logits differ from tp=1's by "
                             f"{max(diff)} > {LOGITS_LIMIT}")
    if all_launches != {k: (want if k == kernel else 0) for k in wrappers()}:
        raise AssertionError(f"{phase}: {all_launches} launches in 4 decode steps, expected "
                             f"{want} of {kernel} (a layer a shard a step) and no other")
    check_card(phase, card, all_launches)
    return result


def mesh_tp_check(torch, dev, weights: dict) -> dict:
    """38. mesh_tp: the serving mesh at tp=2 over two coordinates of the one
    card (``build_mesh(MeshConfig(dp_size=1, tp_size=2), devices=[cuda:0,
    cuda:0])``)."""
    import numpy as np

    from sentio_tpu_torch.config import GeneratorConfig, MeshConfig, Settings
    from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
    from sentio_tpu_torch.parallel.mesh import build_mesh
    from sentio_tpu_torch.parallel.sharding import leaves
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine

    t_phase = time.perf_counter()
    mesh = build_mesh(MeshConfig(dp_size=1, tp_size=MESH_TP), devices=[dev] * MESH_TP)
    mem0 = torch.cuda.memory_allocated()
    caps = dict(max_new_tokens=MAX_TOKENS, verifier_max_tokens=MAX_TOKENS)
    sl = run_slice(torch, dev, "mesh_tp", Settings(generator=GeneratorConfig(**caps)),
                   shared=weights, mesh=mesh)
    pipeline = sl["pipeline"]
    engine = pipeline.generator.provider.engine
    embedder, reranker = pipeline.embedder, pipeline.reranker
    if engine.tp != MESH_TP or not engine.cuda_graphs:
        raise AssertionError(f"mesh_tp: the engine runs tp={engine.tp}, graphs "
                             f"{engine.cuda_graphs}")
    if embedder.params.tp != MESH_TP or reranker.params.tp != MESH_TP:
        raise AssertionError("mesh_tp: the encoders are not sharded over tp")
    # flash: a launch a layer a shard a forward, the encoders' heads
    # dividing over tp
    fwd = sl["forwards"]
    want_flash = MESH_TP * (embedder.model_config.n_layers * fwd["embedder"]
                            + reranker.model_config.n_layers * fwd["reranker"])
    if sl["launches"]["flash_attention"] != want_flash:
        raise AssertionError(f"mesh_tp: flash launched {sl['launches']['flash_attention']} "
                             f"times, the per-shard forwards predict {want_flash} ({fwd})")

    # the card's memory: each shard's weights (what it added beside the
    # source tensors) and its pool
    seen = {leaf.untyped_storage().data_ptr() for _, leaf in leaves(weights["llama_params"])}
    shards = [dict(zip(("bytes", "added_bytes"), shard_bytes(tree, seen)))
              for tree in engine.params]
    memory = {"weights_by_shard": shards,
              "pool_bytes_by_shard": [p.hbm_bytes for p in engine.pool.shards],
              "allocated_after_build": torch.cuda.memory_allocated(),
              "allocated_added": torch.cuda.memory_allocated() - mem0,
              "peak": torch.cuda.max_memory_allocated()}
    emit("mesh_tp_memory", **memory)

    # tp=2 against tp=1 on the same weights: the first decode steps' logits
    pipeline.service.wait_idle()
    prompt = pipeline.generator.build_prompt(sl["questions"][1],
                                             pipeline.index.documents()[:5])
    geometry = dict(max_slots=1, page_size=engine.page_size,
                    max_pages_per_seq=engine.max_pages_per_seq, prefix_cache=False,
                    device=dev)
    cut = cut_depth(weights, MESH_PARITY_LAYERS)
    parity = {}
    for kv_quant, kernel, suffix in (("none", "paged_attention", ""),
                                     ("int8", "paged_attention_quant", "_int8")):
        engines = {f"tp{n}{suffix}": ContinuousBatchingEngine(
            model_config=cut["llama_config"], params=cut["llama_params"], kv_quant=kv_quant,
            mesh=m, **geometry) for n, m in ((1, None), (MESH_TP, mesh))}
        parity[kv_quant] = tp_logits(torch, dev, engines, prompt, f"mesh_tp_logits{suffix}",
                                     kernel)
        for e in engines.values():
            e.release()
        del engines

    # the row-sharded index: 4 coordinates of the card against one
    docs, embs = pipeline.index.documents(), pipeline.index.embeddings()
    index4 = build_mesh(MeshConfig(dp_size=MESH_INDEX_SHARDS), devices=[dev] * MESH_INDEX_SHARDS)
    gen = np.random.default_rng(SEED + 17)
    queries = np.concatenate([embs[:16], gen.standard_normal((16, embs.shape[1]))
                              .astype(np.float32)])
    index_rows = {}
    for dtype in ("float32", "bfloat16"):
        plain = TorchDenseIndex(dim=embs.shape[1], device=dev, dtype=dtype)
        sharded = TorchDenseIndex(dim=embs.shape[1], dtype=dtype, mesh=index4)
        plain.add(docs, embs)
        sharded.add(docs, embs)
        a, b = plain.search_batch(queries, 10), sharded.search_batch(queries, 10)
        ids_equal = sum([d.id for d, _ in x] == [d.id for d, _ in y] for x, y in zip(a, b))
        score_diff = max(abs(s - t) for x, y in zip(a, b) for (_, s), (_, t) in zip(x, y))
        index_rows[dtype] = {"queries": len(queries), "ids_equal": ids_equal,
                             "max_score_diff": score_diff,
                             "blocks": len(sharded._ensure_device()[0])}
        # a block's product takes another reduction order than the whole
        # corpus's (another GEMM shape), so scores may move in the last
        # bits; float32 scores have no ties at that size, so the ids are
        # exact; bf16 scores tie, so ids may swap within one bf16 step
        limit = INDEX_SCORE_LIMIT[dtype]
        if score_diff > limit or (dtype == "float32" and ids_equal != len(queries)):
            raise AssertionError(f"mesh_tp: the {MESH_INDEX_SHARDS}-way index differs from "
                                 f"the unsharded one ({dtype}, scores within {limit}): "
                                 f"{index_rows[dtype]}")
    emit("mesh_tp_index", shards=MESH_INDEX_SHARDS, **index_rows)
    freed = close_pipeline(torch, sl.pop("pipeline"))
    emit("mesh_tp_done", seconds=time.perf_counter() - t_phase, memory_allocated_after=freed,
         chats_s=sl["seconds"])
    return {**sl, "memory": memory, "logits": parity["none"], "logits_int8": parity["int8"],
            "index": index_rows, "want_flash": want_flash}


# ------------------------------------------- the training half of the mesh

# mesh_train's bf16 steps: Llama-3-8B at full width cut to 4 of its 32
# layers (3.9 GB of weights; gradients and AdamW's two moments 11.7 GB)
TRAIN_MESH_LAYERS = 4
# the float32 checks' depth: GPipe against one stage, the ring against
# plain attention
EXACT_LAYERS = 2
TRAIN_ROWS, TRAIN_TOKENS = 4, 257    # a step's batch: 4 rows, 256 targets each
TRAIN_PAD = 64                       # rows 2-4 end in this many padding tokens
# a bf16 mesh step held to the plain step (held_to_plain), set from the
# card's readings (PERF.md §6): the loss's difference, the worst leaf's
# gradient against the plain one's and its AdamW update against AdamW on
# its own gradient; the half batch's step must read past each
# (H100, 700 W; readings / controls: dp × tp 9.25e-5 / 1.77e-2, 2.25e-2 /
# 0.92, 0 / 0.97; ep 1.49e-3 / 5.22e-2, 0.114 / 0.92, 0 / 0.98)
DP_TP_LIMITS = dict(loss=1e-3, grad=5e-2, update=1e-3)
EP_LIMITS = dict(loss=5e-3, grad=0.25, update=1e-3)
PIPE_REL_LIMIT = 1e-4                # float32 pp=2 against pp=1, per leaf
RING_PROMPT_CHARS = 4_000            # ~4,096 tokens of the byte tokenizer
RING_LOGITS_LIMIT = 1e-3             # float32 ring prefill against plain
SP_CHUNKS = 256                      # mesh_sp's and mesh_ep's corpus
PP_LAYERS = 4                        # MESH_PP=2's paged engines
# optax.adamw(1e-3)'s defaults, JAX's dry-run optimizer
ADAMW = dict(lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def repeat_mesh(dev, **fields):
    """A mesh of ``fields``' geometry over repeated coordinates of ``dev``."""
    from sentio_tpu_torch.config import MeshConfig
    from sentio_tpu_torch.parallel.mesh import build_mesh

    return build_mesh(MeshConfig(**fields), devices=[dev] * math.prod(fields.values()))


def train_batch(torch, dev, vocab: int, seed: int):
    """Token ids [TRAIN_ROWS, TRAIN_TOKENS] from the seed and a mask whose
    rows after the first end in TRAIN_PAD padding tokens."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ids = torch.randint(1, vocab, (TRAIN_ROWS, TRAIN_TOKENS), generator=gen, device=dev)
    mask = torch.ones((TRAIN_ROWS, TRAIN_TOKENS), dtype=torch.bool, device=dev)
    mask[1:, TRAIN_TOKENS - TRAIN_PAD:] = False
    return ids, mask


def kernel_counts(torch) -> tuple:
    """The three wrappers' launch counts and the card's own."""
    return {n: k.launches for n, k in wrappers().items()}, card_launches(torch)


def twin_mesh(torch, dev, axis: str, **fields):
    """:func:`repeat_mesh` whose coordinates past the first along ``axis``
    name the card ``cuda`` where the others name it ``cuda:0``: to
    :func:`shard_params` two devices, so every slice replicated over
    ``axis`` is held by two distinct tensors, as on two cards, and the
    step's gradient sum over those copies has work to do."""
    from sentio_tpu_torch.parallel.mesh import MESH_AXES, Mesh

    grid = repeat_mesh(dev, **fields).devices.copy()
    later = [slice(None)] * grid.ndim
    later[MESH_AXES.index(axis)] = slice(1, None)
    grid[tuple(later)] = torch.device(dev.type)
    return Mesh(grid, MESH_AXES)


def err_norms(got, want) -> tuple:
    """``(‖got − want‖², ‖want‖²)``, summed in float32 a block of 2^24
    elements at a time (no float32 copy of a whole leaf)."""
    diff = ref = 0.0
    for g, w in zip(got.reshape(-1).split(1 << 24), want.reshape(-1).split(1 << 24)):
        w = w.float()
        diff += float((g.float() - w).square().sum())
        ref += float(w.square().sum())
    return diff, ref


def grad_of(t):
    """``t``'s gradient, zeros where no forward read it."""
    return t.grad if t.grad is not None else t.new_zeros(t.shape)


def adamw_update(torch, leaf, grad):
    """What one AdamW step at ADAMW moves a copy of ``leaf`` by, given
    ``grad`` (AdamW is elementwise: one leaf alone steps as in a tree)."""
    p = leaf.detach().clone().requires_grad_(True)
    p.grad = grad
    torch.optim.AdamW([p], **ADAMW).step()
    return p.detach() - leaf.detach()


def held_to_plain(torch, phase: str, sharded, tree: dict, loss_of, loss: float,
                  limits: dict) -> dict:
    """The mesh step just taken on ``sharded`` against the plain step on
    the same weights (``tree``, a plain tree of them) and batch, each leaf
    put together from the shards' slices and read as ``‖mesh − want‖ /
    ‖want‖``, gated at the worst leaf by ``limits``: the loss's
    difference; each gradient against the plain one; each AdamW update
    against AdamW on the leaf's own gradient (in bf16 Adam's first step,
    about ``lr · sign(g)``, turns the gradients' rounding into flipped
    signs, so the update is held to the optimizer, the gradient to the
    plain step). The control is the plain step on the batch's first half
    alone, what a step that lost one of two dp groups computes, read over
    the whole tree: each limit must lie below the control's reading, or
    its gate could not fail."""
    from sentio_tpu_torch.parallel.sharding import leaves

    plain = dict(leaves(tree))
    held = {coord: dict(leaves(shard)) for coord, shard in sharded.trees.items()}

    def gathered(path, of):
        out = torch.empty_like(plain[path])
        for coord, tensors in held.items():
            out[tuple(slice(lo, hi) for lo, hi in sharded.slices[coord][path])] = \
                of(tensors[path])
        return out

    def backward(rows) -> float:
        for t in plain.values():
            t.grad = None
        value = loss_of(tree, rows)
        value.backward()
        return value.item()

    # two passes, so the plain tree's gradients and the mesh's are held
    # once each: the full batch against the mesh (each leaf's shards' own
    # gradients dropped once read), then the half batch against the full
    for t in plain.values():
        t.requires_grad_(True)
    losses = {"plain": backward(slice(None))}
    full = {p: grad_of(t) for p, t in plain.items()}
    err: dict = {"grad": {}, "update": {}}
    ctl: dict = {"grad": {}, "update": {}}
    with torch.no_grad():
        for path, leaf in plain.items():
            mine = gathered(path, grad_of)
            err["grad"][path] = err_norms(mine, full[path])
            err["update"][path] = err_norms(gathered(path, lambda t: t) - leaf,
                                            adamw_update(torch, leaf, mine))
            for tensors in held.values():
                tensors[path].grad = None
    losses["control"] = backward(slice(0, TRAIN_ROWS // 2))
    with torch.no_grad():
        for path, leaf in plain.items():
            half = grad_of(leaf)
            ctl["grad"][path] = err_norms(half, full[path])
            ctl["update"][path] = err_norms(adamw_update(torch, leaf, half),
                                            adamw_update(torch, leaf, full[path]))
    for t in plain.values():
        t.requires_grad_(False)
        t.grad = None
    out = {"loss_plain": losses["plain"], "loss_diff": abs(loss - losses["plain"]),
           "loss_control_diff": abs(losses["control"] - losses["plain"])}
    per_leaf = {}
    for kind in ("grad", "update"):
        rel = {p: math.sqrt(d / max(r, 1e-60)) for p, (d, r) in err[kind].items()}
        worst = max(rel, key=rel.get)
        out[kind] = {"rel_err_max": rel[worst], "worst_leaf": worst,
                     "control_rel_err": math.sqrt(sum(d for d, _ in ctl[kind].values())
                                                  / sum(r for _, r in ctl[kind].values()))}
        per_leaf[kind] = rel
    emit(f"{phase}_vs_plain", **out, per_leaf=per_leaf)
    readings = {"loss": (out["loss_diff"], out["loss_control_diff"]),
                **{k: (out[k]["rel_err_max"], out[k]["control_rel_err"])
                   for k in ("grad", "update")}}
    for kind, (got, control) in readings.items():
        limit = limits[kind]
        if control <= limit:
            raise AssertionError(f"{phase}: the {kind} gate cannot fail: the half batch's "
                                 f"step reads {control}, within the limit {limit}")
        if got > limit:
            raise AssertionError(f"{phase}: the {kind} of the mesh step is {got} from the "
                                 f"plain step's, past {limit}")
    return out


def train_step(torch, phase: str, sharded, loss_fn, plain=None, plain_loss_of=None,
               limits=None, **reported) -> dict:
    """One step on ``sharded``'s tensors: ``loss_fn()``, backward, the sum
    of each replicated slice's copies' gradients, one AdamW step. Gates:
    a finite loss, no kernel launched (the losses run plain attention),
    every tensor moved, every replicated slice's copies bit-equal (there
    are copies only where the mesh names two devices, :func:`twin_mesh`);
    given ``plain()`` (the same weights as a plain tree, made after the
    step) and ``plain_loss_of(tree, rows)``, :func:`held_to_plain` at
    ``limits``."""
    from sentio_tpu_torch.parallel.collectives import psum_replicated_grads

    tensors = sharded.parameters()
    for t in tensors:
        t.requires_grad_(True)
    opt = torch.optim.AdamW(tensors, **ADAMW)
    sums0 = torch.stack([t.detach().double().sum() for t in tensors])
    copies = sharded.copies()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts0 = kernel_counts(torch)
    t0 = time.perf_counter()
    loss = loss_fn()
    loss.backward()
    psum_replicated_grads(copies)
    torch.cuda.synchronize()
    t_grad = time.perf_counter()
    counts = kernel_counts(torch)
    opt.step()
    torch.cuda.synchronize()
    t_step = time.perf_counter()
    moved = int((torch.stack([t.detach().double().sum() for t in tensors]) != sums0).sum())
    differing = sum(not torch.equal(g[0], t) for g in copies for t in g[1:])
    result = {"loss": loss.item(), "forward_backward_ms": (t_grad - t0) * 1e3,
              "step_ms": (t_step - t0) * 1e3, "peak_memory": torch.cuda.max_memory_allocated(),
              "tensors": len(tensors), "moved": moved, "replicated_slices": len(copies),
              "copies": sum(map(len, copies)), "copies_differing": differing,
              "launches": {k: n - counts0[0][k] for k, n in counts[0].items()},
              "mesh": dict(sharded.mesh.shape), **reported}
    emit(phase, **result)
    if not math.isfinite(result["loss"]):
        raise AssertionError(f"{phase}: the loss is not finite: {result['loss']}")
    if counts != counts0:
        raise AssertionError(f"{phase}: a kernel launched under autograd: {counts0} -> {counts}")
    if moved != len(tensors) or differing:
        raise AssertionError(f"{phase}: {len(tensors) - moved} tensors did not move, "
                             f"{differing} replicated copies differ")
    opt = None  # AdamW's moments: the plain step below needs the room
    if plain is not None:
        result["vs_plain"] = held_to_plain(torch, phase, sharded, plain(), plain_loss_of,
                                           result["loss"], limits)
    for t in tensors:
        t.requires_grad_(False)
        t.grad = None
    return result


def mesh_train_check(torch, dev) -> dict:
    """mesh_train: JAX's dry-run train steps on repeated coordinates of the
    card, Llama-3-8B's widths at TRAIN_MESH_LAYERS layers in bf16, random
    weights from the seed, a padded batch of 4 × 257 tokens, AdamW at
    optax.adamw(1e-3)'s defaults. The dp=2 × tp=2 step (``llama_loss``, the
    batch split over dp, on a :func:`twin_mesh` so each dp group holds its
    own copies) against the plain step on the same weights and batch
    (:func:`held_to_plain`); the dp=1 × pp=2 × tp=2 GPipe step
    (``pipeline_loss``, 2 microbatches);
    then, at EXACT_LAYERS layers in float32, ``pipeline_loss`` and every
    gradient at pp=2 against pp=1."""
    from sentio_tpu_torch.models.llama import (
        LlamaConfig,
        init_llama,
        llama_loss,
        stack_layer_params,
    )
    from sentio_tpu_torch.parallel.pipeline import pipeline_loss, shard_stacked_params
    from sentio_tpu_torch.parallel.sharding import LLAMA_TP_RULES, leaves, shard_params

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=TRAIN_MESH_LAYERS)
    ids, mask = train_batch(torch, dev, cfg.vocab_size, SEED + 21)

    def weights(c):
        return init_llama(c, torch.Generator(device=dev).manual_seed(SEED + 22), dev)

    sharded = shard_params(weights(cfg), twin_mesh(torch, dev, "dp", dp_size=2, tp_size=2),
                           LLAMA_TP_RULES)
    dp_tp = train_step(torch, "mesh_train_dp_tp", sharded,
                       lambda: llama_loss(sharded, cfg, ids, mask), plain=lambda: weights(cfg),
                       plain_loss_of=lambda tree, rows: llama_loss(tree, cfg, ids[rows],
                                                                   mask[rows]),
                       limits=DP_TP_LIMITS)
    del sharded
    gc.collect()
    torch.cuda.empty_cache()

    stacked = shard_stacked_params(stack_layer_params(weights(cfg), cfg),
                                   repeat_mesh(dev, pp_size=2, tp_size=2))
    gpipe = train_step(torch, "mesh_train_gpipe", stacked,
                       lambda: pipeline_loss(stacked, cfg, ids, mask, n_micro=2))
    del stacked
    gc.collect()
    torch.cuda.empty_cache()

    c32 = dataclasses.replace(cfg, n_layers=EXACT_LAYERS, dtype="float32")
    plain = stack_layer_params(weights(c32), c32)
    tensors = dict(leaves(plain))
    for t in tensors.values():
        t.requires_grad_(True)
    runs = {}
    for pp in (1, 2):
        t0 = time.perf_counter()
        loss = pipeline_loss(plain, c32, ids, mask, repeat_mesh(dev, pp_size=pp, tp_size=2),
                             n_micro=2)
        loss.backward()
        torch.cuda.synchronize()
        runs[pp] = {"loss": loss.item(), "ms": (time.perf_counter() - t0) * 1e3,
                    "grads": {p: t.grad for p, t in tensors.items()}}
        for t in tensors.values():
            t.grad = None
    rel = {p: float((runs[2]["grads"][p] - g).abs().max() / g.abs().max().clamp_min(1e-30))
           for p, g in runs[1]["grads"].items()}
    loss_rel = abs(runs[2]["loss"] - runs[1]["loss"]) / abs(runs[1]["loss"])
    exact = {"layers": EXACT_LAYERS, "loss_pp1": runs[1]["loss"], "loss_pp2": runs[2]["loss"],
             "loss_rel_diff": loss_rel, "grad_rel_diff_max": max(rel.values()),
             "worst_leaf": max(rel, key=rel.get), "ms_pp1": runs[1]["ms"],
             "ms_pp2": runs[2]["ms"]}
    emit("mesh_train_gpipe_f32", **exact)
    del plain, tensors, runs
    gc.collect()
    torch.cuda.empty_cache()
    if loss_rel > PIPE_REL_LIMIT or exact["grad_rel_diff_max"] > PIPE_REL_LIMIT:
        raise AssertionError(f"mesh_train: float32 pp=2 against pp=1 past {PIPE_REL_LIMIT}: "
                             f"{exact}")
    seconds = time.perf_counter() - t_phase
    emit("mesh_train_done", seconds=seconds, memory_allocated_after=torch.cuda.memory_allocated())
    return {"dp_tp": dp_tp, "gpipe": gpipe, "gpipe_f32": exact, "seconds": seconds}


def ring_prompt(words) -> str:
    """A prompt of RING_PROMPT_CHARS bytes (a token each, BOS before them)."""
    text = " ".join(words)
    while len(text) < RING_PROMPT_CHARS:
        text = f"{text} {text}"
    return text[:RING_PROMPT_CHARS]


def prefill_logits(torch, engine, prompt: str):
    """The contiguous engine's prefill of one prompt: its real rows' logits
    and the prefill's ms."""
    ids, positions, lens, cache, _, _, pad_mask = engine._encode_batch([prompt], 8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits = engine._prefill(ids, positions, cache, pad_mask)[0, : int(lens[0])]
    torch.cuda.synchronize()
    return logits, (time.perf_counter() - t0) * 1e3, int(lens[0])


def mesh_sp_check(torch, dev, weights: dict) -> dict:
    """mesh_sp: sequence parallelism on sp=2 × tp=2 of the card. The
    contiguous engine's ring prefill of a ~4,096-token prompt against the
    sp=1 engine's plain attention (Llama-3-8B's widths, EXACT_LAYERS layers,
    float32): logits and 8 greedy tokens. Then ``/chat`` with
    ``USE_PAGED_KV=0`` on that mesh at CONTIG_LAYERS on the shared bf16
    weights over SP_CHUNKS chunks: answered, not degraded, the prefills on
    the ring, no flash launch (the encoders run plain attention at sp > 1,
    as JAX picks it). Then MESH_PP=2: a paged engine on pp=2 of the card
    (PP_LAYERS layers, shared weights) against one without a mesh."""
    from sentio_tpu_torch.config import GeneratorConfig, MeshConfig, Settings
    from sentio_tpu_torch.models.llama import LlamaConfig, init_llama
    from sentio_tpu_torch.runtime.engine import GeneratorEngine
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine

    t_phase = time.perf_counter()
    _, words = corpus(64)
    prompt = ring_prompt(words)
    c32 = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=EXACT_LAYERS, dtype="float32")
    params = init_llama(c32, torch.Generator(device=dev).manual_seed(SEED + 23), dev)
    gcfg = GeneratorConfig(max_new_tokens=8)
    plain = GeneratorEngine(gcfg, model_config=c32, params=params, device=dev)
    plain.attn_fn = None
    ring = GeneratorEngine(gcfg, model_config=c32, params=params,
                           mesh=repeat_mesh(dev, sp_size=2, tp_size=2))
    counts0 = kernel_counts(torch)
    with torch.inference_mode():
        want, plain_ms, n_tokens = prefill_logits(torch, plain, prompt)
        got, ring_ms, _ = prefill_logits(torch, ring, prompt)
        diff = float((got - want).abs().max())
        del want, got
        tokens = {name: e.generate([prompt], max_new_tokens=8, temperature=0.0)[0].tokens
                  for name, e in (("plain", plain), ("ring", ring))}
    counts = kernel_counts(torch)
    parity = {"prompt_tokens": n_tokens, "layers": EXACT_LAYERS, "logits_max_abs_diff": diff,
              "plain_prefill_ms": plain_ms, "ring_prefill_ms": ring_ms,
              "greedy_equal": tokens["plain"] == tokens["ring"], "tokens": tokens["ring"],
              "ring_prefills": ring.ring_prefills, "prefill_attention": ring.prefill_attention}
    emit("mesh_sp_parity", **parity)
    del plain, ring, params
    gc.collect()
    torch.cuda.empty_cache()
    if (diff > RING_LOGITS_LIMIT or not parity["greedy_equal"]
            or parity["prefill_attention"] != "ring" or parity["ring_prefills"] < 2):
        raise AssertionError(f"mesh_sp: the ring prefill differs from plain attention: {parity}")
    if counts != counts0:
        raise AssertionError(f"mesh_sp: a kernel launched under the ring or plain attention: "
                             f"{counts0} -> {counts}")

    mesh = repeat_mesh(dev, dp_size=1, sp_size=2, tp_size=2)
    settings = Settings(generator=GeneratorConfig(use_paged_decode=False,
                                                  max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS),
                        mesh=MeshConfig(sp_size=2, tp_size=2))
    pipeline, docs, words, _ = build_slice(torch, dev, "mesh_sp", settings,
                                           cut_depth(weights, CONTIG_LAYERS), mesh=mesh,
                                           n_chunks=SP_CHUNKS)
    engine = pipeline.generator.provider.engine
    rings0 = engine.ring_prefills
    window = chat_window(torch, pipeline, slice_questions(docs, words)[1:2])
    (response, chat_s), = window["chats"]
    check_answered("mesh_sp", 0, response)
    serving = {"chat_s": chat_s, "stage_ms": response["metadata"]["stage_ms"],
               "launches": window["launches"], "device_launches": window["card"],
               "encoder_forwards": window["forwards"], "prefills": engine.prefills,
               "ring_prefills": engine.ring_prefills - rings0,
               "prefill_attention": engine.prefill_attention,
               "encoders_attn": [pipeline.embedder.attn_fn, pipeline.reranker.attn_fn],
               "peak_memory": torch.cuda.max_memory_allocated()}
    serving["encoders_attn"] = [f is not None for f in serving["encoders_attn"]]
    emit("mesh_sp", **serving)
    close_pipeline(torch, pipeline)
    pipeline = engine = None
    if any(window["launches"].values()) or any(serving["encoders_attn"]):
        raise AssertionError(f"mesh_sp: a kernel launched at sp=2 (the encoders run plain "
                             f"attention, the prefill the ring): {serving}")
    if serving["prefill_attention"] != "ring" or serving["ring_prefills"] < 2:
        raise AssertionError(f"mesh_sp: the chat's prefills did not ride the ring: {serving}")
    check_card("mesh_sp", window["card"], window["launches"])

    cut = cut_depth(weights, PP_LAYERS)
    geometry = dict(max_slots=2, page_size=128, max_pages_per_seq=16, device=dev,
                    prefix_cache=False)
    pp = {}
    for name, m in (("pp1", None), ("pp2", repeat_mesh(dev, pp_size=2))):
        e = ContinuousBatchingEngine(model_config=cut["llama_config"],
                                     params=cut["llama_params"], mesh=m, **geometry)
        pp[name] = [r.tokens for r in e.run_all([q for q in slice_questions(docs, words)[:2]],
                                                max_new_tokens=16)]
        e.release()
        del e
    emit("mesh_sp_pp", layers=PP_LAYERS, tokens=pp, equal=pp["pp1"] == pp["pp2"])
    if pp["pp1"] != pp["pp2"]:
        raise AssertionError(f"mesh_sp: the MESH_PP=2 engine's greedy tokens differ: {pp}")
    seconds = time.perf_counter() - t_phase
    emit("mesh_sp_done", seconds=seconds, memory_allocated_after=torch.cuda.memory_allocated())
    return {"parity": parity, "serving": serving, "pp": pp, "seconds": seconds}


def mesh_ep_check(torch, dev, weights: dict) -> dict:
    """mesh_ep: a MoE model on dp=1 × ep=2 × tp=2 of the card
    (``MOE_EP_RULES``). Mixtral-8x7B's widths at EXACT_LAYERS layers in
    bf16: a paged ``/chat`` through ``build_pipeline`` over SP_CHUNKS chunks
    (the paged kernel once per layer per tp shard per sub-step, = the
    card's), then one prompt's prefill and 4 decode steps against the
    single-device engine, bf16 and int8, within the logits limit; at
    ``bench.py``'s ``moe`` geometry in float32, greedy tokens equal to the
    single-device engine's; one ep train step (``moe_loss``, AdamW) at
    Mixtral's widths and one layer on a :func:`twin_mesh` along ep, held to
    the plain step (:func:`held_to_plain`)."""
    from sentio_tpu_torch.config import GeneratorConfig, Settings
    from sentio_tpu_torch.models.moe import init_moe, moe_loss
    from sentio_tpu_torch.parallel.sharding import MOE_EP_RULES, shard_params
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine, _paged_attn_xla

    t_phase = time.perf_counter()
    mesh = repeat_mesh(dev, dp_size=1, ep_size=2, tp_size=2)
    cfg = mixtral_config(EXACT_LAYERS)
    params = init_moe(cfg, torch.Generator(device=dev).manual_seed(SEED + 13), dev)
    encoders = {k: v for k, v in weights.items() if not k.startswith("llama")}
    caps = dict(max_new_tokens=MAX_TOKENS, verifier_max_tokens=MAX_TOKENS)
    # at 2 random layers the router leaves an expert without a choice in one
    # chat (expert 1 had 0 of 17,104 in the first run on the card): the
    # drop gate holds, not the every-expert one, which slice_moe keeps
    sl = run_slice(torch, dev, "mesh_ep", Settings(generator=GeneratorConfig(**caps)),
                   shared={**encoders, "llama_config": cfg, "llama_params": params},
                   n_chats=1, mesh=mesh, n_chunks=SP_CHUNKS, every_expert=False)
    pipeline = sl.pop("pipeline")
    engine = pipeline.generator.provider.engine
    if engine.tp != 2 or len(engine.params.experts) != 2 or not engine.cuda_graphs:
        raise AssertionError(f"mesh_ep: the engine runs tp={engine.tp} over "
                             f"{len(engine.params.experts)} ep shards, graphs "
                             f"{engine.cuda_graphs}")
    pipeline.service.wait_idle()
    prompt = pipeline.generator.build_prompt(sl["questions"][0],
                                             pipeline.index.documents()[:5])
    sharded = engine.sharded
    geometry = dict(max_slots=1, page_size=engine.page_size,
                    max_pages_per_seq=engine.max_pages_per_seq, prefix_cache=False, device=dev)
    close_pipeline(torch, pipeline)
    pipeline = engine = None
    logits = {}
    for kv_quant, kernel, suffix in (("none", "paged_attention", ""),
                                     ("int8", "paged_attention_quant", "_int8")):
        engines = {f"ep1{suffix}": ContinuousBatchingEngine(
                       model_config=cfg, params=params, kv_quant=kv_quant, **geometry),
                   f"ep2_tp2{suffix}": ContinuousBatchingEngine(
                       model_config=cfg, params=sharded, kv_quant=kv_quant, mesh=mesh,
                       **geometry)}
        logits[kv_quant] = tp_logits(torch, dev, engines, prompt, f"mesh_ep_logits{suffix}",
                                     kernel)
        for e in engines.values():
            e.release()
        del engines
    del sharded, params
    gc.collect()
    torch.cuda.empty_cache()

    bench = bench_moe_config("float32")
    bparams = init_moe(bench, torch.Generator(device=dev).manual_seed(SEED + 14), dev)
    greedy = {}
    for name, m in (("ep1", None), ("ep2_tp2", mesh)):
        e = ContinuousBatchingEngine(model_config=bench, params=bparams, mesh=m, max_slots=4,
                                     page_size=16, max_pages_per_seq=8, steps_per_tick=4,
                                     device=dev)
        e.attn_impl = _paged_attn_xla  # a float32 pool: the kernels take bf16
        greedy[name] = [r.tokens for r in e.run_all(["experts on a mesh", "second lane"],
                                                     max_new_tokens=8)]
        e.release()
        del e
    emit("mesh_ep_greedy", config=dataclasses.asdict(bench), tokens=greedy,
         equal=greedy["ep1"] == greedy["ep2_tp2"])
    del bparams
    gc.collect()
    torch.cuda.empty_cache()
    if greedy["ep1"] != greedy["ep2_tp2"]:
        raise AssertionError(f"mesh_ep: ep=2 × tp=2 greedy tokens differ from one device's: "
                             f"{greedy}")

    c1 = mixtral_config(1)
    ids, mask = train_batch(torch, dev, c1.vocab_size, SEED + 24)

    def moe_weights():
        return init_moe(c1, torch.Generator(device=dev).manual_seed(SEED + 25), dev)

    tparams = shard_params(moe_weights(), twin_mesh(torch, dev, "ep", dp_size=1, ep_size=2,
                                                    tp_size=2), MOE_EP_RULES)
    step = train_step(torch, "mesh_ep_train", tparams, lambda: moe_loss(tparams, c1, ids, mask),
                      plain=moe_weights,
                      plain_loss_of=lambda tree, rows: moe_loss(tree, c1, ids[rows], mask[rows]),
                      limits=EP_LIMITS)
    del tparams
    gc.collect()
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit("mesh_ep_done", seconds=seconds, memory_allocated_after=torch.cuda.memory_allocated())
    return {**sl, "logits": logits["none"], "logits_int8": logits["int8"], "greedy": greedy,
            "train": step, "seconds": seconds}


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


# ------------------------------------------------------------- the sanitizer

SANITIZE_CHATS = 12       # concurrent generations over two 512-token heads
SANITIZE_RAG_CHATS = 2    # /chat answers beside them (the encoders' flash)
SANITIZE_DOCS = 64        # ingested for those chats
SANITIZE_STREAM_TOKENS = 256   # the stream dropped after its first piece


class Sanitized:
    """``SENTIO_SANITIZE=1`` while the sanitize phase constructs its objects
    (the setting is read at construction), the prior value after."""

    def __enter__(self) -> "Sanitized":
        self.prior = os.environ.get("SENTIO_SANITIZE")
        os.environ["SENTIO_SANITIZE"] = "1"
        return self

    def __exit__(self, *exc) -> None:
        if self.prior is None:
            os.environ.pop("SENTIO_SANITIZE", None)
        else:
            os.environ["SENTIO_SANITIZE"] = self.prior


class CheckTimer:
    """Installed over ``runtime.paged.check_engine_invariants`` (the name
    each tick calls): the real check runs unchanged, and each call's host
    ms and each ``SanitizerError`` are kept per engine. The package counts
    nothing of its own for this."""

    def __init__(self) -> None:
        from sentio_tpu_torch.runtime import paged

        self.paged = paged
        self.real = paged.check_engine_invariants
        self.ms: dict = {}
        self.errors: list = []
        paged.check_engine_invariants = self

    def __call__(self, engine) -> None:
        t0 = time.perf_counter()
        try:
            self.real(engine)
        except Exception as exc:
            self.errors.append((id(engine), str(exc)))
            raise
        finally:
            self.ms.setdefault(id(engine), []).append((time.perf_counter() - t0) * 1e3)

    def remove(self) -> None:
        self.paged.check_engine_invariants = self.real

    def of(self, *engines) -> dict:
        ms = [x for e in engines for x in self.ms.get(id(e), [])]
        return {"ticks": len(ms), "p50_ms": percentile(ms, 0.5) if ms else None,
                "max_ms": max(ms) if ms else None}


def tick_ms(recorder, since_tick: int, replica: int) -> list:
    """The pump ticks' own ms of ``replica`` on the flight recorder, after
    event ``since_tick``."""
    return [e["dur_ms"] for e in recorder.events() if e["tick"] > since_tick
            and "event" not in e and e.get("replica") == replica and "dur_ms" in e]


def sanitize_burst(rs, pipeline, heads: list, words) -> dict:
    """``SANITIZE_CHATS`` generations at once through the replica set, each
    on one of two 512-token heads, from tenants a and b; the first a stream
    dropped after its first piece (its slot cancelled); beside them
    ``SANITIZE_RAG_CHATS`` /chat answers. Every caller must succeed."""
    import threading

    out: list = [None] * (SANITIZE_CHATS + SANITIZE_RAG_CHATS)
    start = threading.Barrier(len(out))

    def run(i: int) -> None:
        start.wait(timeout=60)
        try:
            if i >= SANITIZE_CHATS:
                question = f"What does the corpus say about {words[7 * i]}?"
                out[i] = ("chat", pipeline.chat(question))
                return
            prompt = f"{heads[i % 2]} Q{i}: what links {words[3 * i]} to {words[3 * i + 1]}?"
            if i == 0:
                stream = rs.generate_stream(prompt, max_new_tokens=SANITIZE_STREAM_TOKENS,
                                            tenant="a")
                first = next(stream)
                stream.close()
                out[i] = ("dropped", first)
            else:
                out[i] = ("generate", rs.generate(prompt, max_new_tokens=MAX_TOKENS,
                                                  tenant="ab"[i % 2], timeout_s=300))
        except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
            out[i] = ("raised", exc)

    threads = [threading.Thread(target=run, args=(i,), name=f"smoke-sanitize-{i}",
                                daemon=True) for i in range(len(out))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=HTTP_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"sanitize: a chat did not return within {HTTP_TIMEOUT_S:.0f} s")
    replicas = []
    for i, (kind, value) in enumerate(out):
        if kind == "raised":
            raise AssertionError(f"sanitize chat {i} raised: {value!r}") from value
        if kind == "chat":
            check_answered("sanitize", i, value)
        elif kind == "generate":
            if value.finish_reason not in ("stop", "length"):
                raise AssertionError(f"sanitize chat {i} ended {value.finish_reason}")
            replicas.append(value.replica_id)
    return {"replicas": replicas, "dropped_first_piece": out[0][1]}


def sanitize_rebuild(torch, rs, words) -> dict:
    """Replica 0 quarantined by the supervisor's own entry point while two
    threads send generations: drained, its engine released, a fresh one
    (armed: built under the setting) warmed and swapped in. No tick fails."""
    import threading

    t0 = time.perf_counter()
    old = rs.services[0]
    done: list = []
    stop = threading.Event()

    def traffic(k: int) -> None:
        i = 0
        while not stop.is_set():
            word = words[(300 + 7 * k + i) % len(words)]
            try:
                result = rs.generate(f"While replica 0 rebuilds, what about {word}?",
                                     max_new_tokens=16, tenant="ab"[k], timeout_s=300)
            except Exception as exc:  # noqa: BLE001 — raised below, on the main thread
                done.append(("raised", exc, None))
                return
            done.append((rs.health_summary()["replicas"][0]["state"], result.finish_reason,
                         result.replica_id))
            i += 1

    threads = [threading.Thread(target=traffic, args=(k,), name=f"smoke-sanitize-rebuild-{k}",
                                daemon=True) for k in range(2)]
    with Sanitized():
        for t in threads:
            t.start()
        try:
            wait_for(lambda: len(done) >= 2, 120, "traffic before the rebuild")
            rs._quarantine(0, "sanitize phase: rebuild under traffic")
            wait_for(lambda: rs.services[0] is not old
                     and rs.health_summary()["replicas"][0]["state"] == "HEALTHY",
                     300, "replica 0's rebuild", poll_s=0.25)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=HTTP_TIMEOUT_S)
    if any(t.is_alive() for t in threads):
        raise AssertionError(f"sanitize: a rebuild-traffic thread did not return within "
                             f"{HTTP_TIMEOUT_S:.0f} s")
    raised = [d[1] for d in done if d[0] == "raised"]
    if raised:
        raise AssertionError(f"sanitize: {len(raised)} generation(s) raised during the "
                             f"rebuild: {raised!r}") from raised[0]
    fresh = rs.services[0]
    during = [d for d in done if d[0] != "HEALTHY"]
    result = {"seconds": time.perf_counter() - t0, "chats": len(done),
              "chats_during_rebuild": len(during),
              "during_replicas": sorted({d[2] for d in during}),
              "finish_reasons": sorted({d[1] for d in done}),
              "fresh_armed": fresh.engine._san is not None,
              "fresh_guard": getattr(fresh.engine._san, "name", None),
              "old_pool_released": old.engine.pool is None}
    if not result["fresh_armed"] or result["fresh_guard"] != "ContinuousBatchingEngine[r0]" \
            or not result["old_pool_released"] or 1 not in result["during_replicas"] \
            or set(result["finish_reasons"]) - {"stop", "length"}:
        raise AssertionError(f"sanitize: the rebuild under traffic: {result}")
    return {**result, "old": old, "fresh": fresh}


def sanitize_int8(torch, dev, weights, heads: list, timer: CheckTimer) -> dict:
    """One int8 engine at the serving geometry, armed, driven directly for a
    few ticks; then the check shown live on the card (a page popped from
    the free list is named on the next tick, and the engine steps clean
    once it is back), and one check with slots active under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from sentio_tpu_torch.analysis.sanitizer import SanitizerError
    from sentio_tpu_torch.config import GeneratorConfig
    from sentio_tpu_torch.pipeline import engine_settings
    from sentio_tpu_torch.runtime.paged import ContinuousBatchingEngine

    with Sanitized():
        eng = ContinuousBatchingEngine(model_config=weights["llama_config"],
                                       params=weights["llama_params"], device=dev,
                                       **engine_settings(GeneratorConfig(kv_quant="int8")))
    if eng._san is None or not eng.pool.quantized:
        raise AssertionError("sanitize_int8: the engine is not armed or not int8")
    step_ms = []

    def drain() -> None:
        while eng.has_work:
            t0 = time.perf_counter()
            eng.step()
            step_ms.append((time.perf_counter() - t0) * 1e3)

    for i in range(4):
        eng.submit(f"{heads[i % 2]} int8 row {i}?", max_new_tokens=32)
    drain()
    ticks = timer.of(eng)["ticks"]
    # the check is live on the card: a page lost from the free list
    leaked = eng.allocator._free.pop()
    eng.submit(f"{heads[0]} after the leak?", max_new_tokens=8)
    caught = ""
    try:
        drain()
    except SanitizerError as exc:
        caught = str(exc)
    if f"leaked=[{leaked}]" not in caught:
        raise AssertionError(f"sanitize_int8: the leaked page {leaked} was not named: "
                             f"{caught!r}")
    eng.allocator._free.append(leaked)
    drain()
    timer.real(eng)
    # one check with slots active: host metadata only, no device sync
    eng.submit(f"{heads[1]} sync probe?", max_new_tokens=16)
    eng.step()
    active = sum(s.active for s in eng.slots)
    torch.cuda.set_sync_debug_mode("error")
    try:
        timer.real(eng)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    drain()
    return {"engine": eng, "ticks_before_leak": ticks, "leaked_page": leaked,
            "caught": caught, "active_under_sync_check": active,
            "step_p50_ms": percentile(step_ms, 0.5), "num_pages": eng.allocator.num_pages}


def sanitize_check(torch, dev, weights, unarmed_lone: dict) -> dict:
    """sanitize: the replica tier and an int8 engine armed with
    ``SENTIO_SANITIZE=1`` (set while their objects are built), on the tier's
    weights. Two thread-mode replicas with the prefix cache and the warmed
    head (AFFINITY_STICKINESS 0.5), ``SANITIZE_CHATS`` generations at once
    over two 512-token heads, one stream dropped mid-way, two /chat
    answers; a lone greedy request; replica 0 rebuilt under traffic; then
    :func:`sanitize_int8`. Gates: every engine armed and its ticks checked
    (each replica's, the int8 engine's), no sanitizer error but the one
    injected, no tick failure, both replicas served and donated pages to
    their trees, the lone greedy text equal to the unarmed ``replicas_2``
    answer, each wrapper's launches equal to the card's and the paged
    kernels once per layer per sub-step. Reported: the check's host ms per
    tick (p50, max) beside the ticks' own ms, the pools' page counts."""
    from sentio_tpu_torch.analysis.sanitizer import OwnedLock
    from sentio_tpu_torch.config import GeneratorConfig, ServeConfig, Settings
    from sentio_tpu_torch.infra.flight import get_flight_recorder
    from sentio_tpu_torch.pipeline import build_pipeline

    phase = "sanitize"
    t_phase = time.perf_counter()
    docs, words = corpus(SANITIZE_DOCS)
    heads = [docs[1].text[:511], docs[2].text[:511]]
    settings = Settings(generator=GeneratorConfig(max_new_tokens=MAX_TOKENS,
                                                  verifier_max_tokens=MAX_TOKENS),
                        serve=ServeConfig(replicas=2, affinity_stickiness=REPLICA_STICKINESS))
    gc.collect()
    torch.cuda.empty_cache()
    timer = CheckTimer()
    recorder = get_flight_recorder()
    pipeline = None
    try:
        with Sanitized():
            pipeline = build_pipeline(settings, device=dev, seed=SEED, **weights)
        rs = pipeline.replica_set
        engines = [svc.engine for svc in rs.services]
        armed = {"engines": [e._san is not None for e in engines],
                 "guards": [e._san.name if e._san else None for e in engines],
                 "locks": [isinstance(x, OwnedLock) for x in
                           (rs._mutex, rs.tenants._mutex, *(s._mutex for s in rs.services))],
                 "locksets": ["_san_lockset_state" in x.__dict__ for x in (rs, *rs.services)]}
        if not all(v for vals in armed.values() for v in vals):
            raise AssertionError(f"{phase}: not every object is armed: {armed}")
        warm = pipeline.warmup()
        if min(warm["head_tokens"]) <= 0:
            raise AssertionError(f"{phase}: the template head was not warmed: {warm}")
        pipeline.ingest(docs)
        rs.wait_idle()
        stats0 = [svc.stats() for svc in rs.services]
        sub0 = [e.total_sub_steps for e in engines]
        tick0 = recorder.record_tick(event="smoke_mark", phase=phase)
        window = LaunchWindow(torch)
        burst = sanitize_burst(rs, pipeline, heads, words)
        rs.wait_idle()
        stats1 = [svc.stats() for svc in rs.services]
        lone = lone_greedy(rs)
        rebuild = sanitize_rebuild(torch, rs, words)
        rs.wait_idle()
        old, fresh = rebuild.pop("old"), rebuild.pop("fresh")
        int8 = sanitize_int8(torch, dev, weights, heads, timer)
        eng8 = int8.pop("engine")
        launches, card = window.read()
        n_layers = weights["llama_config"].n_layers
        sub_steps = (old.engine.total_sub_steps - sub0[0] + fresh.engine.total_sub_steps
                     + rs.services[1].engine.total_sub_steps - sub0[1])
        checks = {"replica_0": timer.of(old.engine, fresh.engine),
                  "replica_0_old": timer.of(old.engine), "replica_0_fresh": timer.of(fresh.engine),
                  "replica_1": timer.of(engines[1]), "int8": timer.of(eng8)}
        ticks = {r: tick_ms(recorder, tick0, r) for r in (0, 1)}
        failures = [s.tick_failure_count for s in (old, fresh, rs.services[1])]
        result = {
            "armed": armed, "warm_head_tokens": warm["head_tokens"],
            "chats": SANITIZE_CHATS, "rag_chats": SANITIZE_RAG_CHATS,
            "burst_replicas": burst["replicas"],
            "prefix_hits": [b["prefix_hits"] - a["prefix_hits"] for a, b in zip(stats0, stats1)],
            "prefix_cache_pages": [s["prefix_cache_pages"] for s in stats1],
            "cancelled": sum(b["cancelled"] - a["cancelled"] for a, b in zip(stats0, stats1)),
            "lone": lone, "lone_equal": lone["text"] == unarmed_lone["text"],
            "rebuild": rebuild, "int8": int8, "checks": checks,
            "check_p50_ms": {k: v["p50_ms"] for k, v in checks.items()},
            "check_max_ms": {k: v["max_ms"] for k, v in checks.items()},
            "tick_p50_ms": {f"replica_{r}": percentile(v, 0.5) if v else None
                            for r, v in ticks.items()},
            "int8_step_p50_ms": int8["step_p50_ms"],
            "num_pages": {"replicas": [e.allocator.num_pages for e in engines],
                          "int8": int8["num_pages"]},
            "sanitizer_errors": [m for _id, m in timer.errors],
            "tick_failures": failures, "sub_steps": sub_steps,
            "launches": launches, "device_launches": card,
            "seconds": time.perf_counter() - t_phase}
        emit(phase, **result)
        if any(checks[k]["ticks"] <= 0 for k in ("replica_0_old", "replica_0_fresh",
                                                 "replica_1", "int8")):
            raise AssertionError(f"{phase}: an engine's ticks were not checked: {checks}")
        if len(timer.errors) != 1 or str(int8["leaked_page"]) not in timer.errors[0][1] \
                or timer.errors[0][0] != id(eng8) or any(failures):
            raise AssertionError(f"{phase}: sanitizer errors other than the injected leak, or "
                                 f"failed ticks: {timer.errors}, {failures}")
        if sorted(set(burst["replicas"])) != [0, 1] or min(result["prefix_hits"]) <= 0 \
                or min(result["prefix_cache_pages"]) <= 0 or result["cancelled"] < 1:
            raise AssertionError(f"{phase}: both replicas must serve, hit and hold their "
                                 f"trees, and the dropped stream be cancelled: {result}")
        if not result["lone_equal"]:
            raise AssertionError(f"{phase}: the armed lone greedy text differs from the "
                                 f"unarmed replicas_2 answer: {lone} vs {unarmed_lone}")
        if launches["paged_attention"] != n_layers * sub_steps or sub_steps <= 0 \
                or launches["paged_attention_quant"] != n_layers * eng8.total_sub_steps \
                or launches["flash_attention"] <= 0:
            raise AssertionError(f"{phase}: launches are not one per layer per sub-step "
                                 f"({sub_steps} bf16, {eng8.total_sub_steps} int8), or no "
                                 f"flash: {launches}")
        check_card(phase, card, launches)
        return result
    finally:
        timer.remove()
        if pipeline is not None:
            close_pipeline(torch, pipeline)


def main(argv=None) -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--only-new", action="store_true",
                        help="build, the kernel checks, then only convert_serve; ends "
                             "without the result lines")
    parser.add_argument("--worker-rounds", action="store_true",
                        help="build, then the rounds of one and two replicas in thread and "
                             "in process mode (random 8B weights); ends without the result "
                             "lines")
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
    if args.worker_rounds:
        build_all(KERNELS)
        worker_rounds(torch, dev)
        return 0

    import threading

    bm25: dict = {}

    def build_bm25() -> None:
        t0 = time.perf_counter()
        bm25["built"] = native.load_bm25() is not None
        bm25["seconds"] = time.perf_counter() - t0

    # the BM25 core's g++ runs beside the kernels' nvcc
    bm25_build = threading.Thread(target=build_bm25, name="smoke-bm25-build", daemon=True)
    bm25_build.start()
    sweep, sweep_quant = span_sweep(), span_sweep(quant=True)
    seconds = build_all([*KERNELS, *(k for k in (*sweep.values(), *sweep_quant.values())
                                     if k not in KERNELS)])
    bm25_build.join(timeout=300)
    tensor_core = {k.name: sass_counts(k) for k in KERNELS}
    emit("build", seconds=seconds, bm25_core_built=bm25.get("built", False),
         bm25_core_seconds=bm25.get("seconds"), sass_tensor_core=tensor_core, ptxas={
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
    tp2 = tp2_kernel_cases(torch, dev, sweep, sweep_quant)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if args.only_new:
        convert_serve_check(torch, dev, settings_weights(torch, dev))
        return 0

    # the MoE phases first: their 47 GB of weights cannot sit beside the
    # 8B's, and the 8B tensors stay referenced to the end (a SIGKILLed
    # worker never releases its CUDA IPC handles on them)
    t0 = time.perf_counter()
    moe = moe_phases(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.ipc_collect()
    # what stays: moe_exact's float32 weights (5.24 GB), which its worker
    # took over CUDA IPC and, exiting without teardown, never released
    emit("moe_phases", seconds=time.perf_counter() - t0,
         memory_allocated_after=torch.cuda.memory_allocated())
    if torch.cuda.memory_allocated() > 8 << 30:
        raise AssertionError("moe_phases: the MoE weights outlived their phases: "
                             f"{torch.cuda.memory_allocated()} bytes still allocated")
    sm, sm8, pm = moe["slice_moe"], moe["slice_moe_int8"], moe["profile_moe"]

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
    st = serve_settings_check(torch, dev, weights)["chats"]
    chunked_check(torch, dev, sl["generate_prompt"])

    # USE_PAGED_KV=0 with the default hybrid retrieval, on the same weights
    sc = run_contig_slice(torch, dev, Settings(generator=GeneratorConfig(
        use_paged_decode=False, **caps)), shared=cut_depth(weights, CONTIG_LAYERS))
    contig_logits_check(torch, sc["pipeline"], sc["generate_prompt"])
    contig_vs_paged_check(torch, dev, sl["generate_prompt"])

    # speculation: the earlier pipelines' pools go first; the weights stay
    freed = {name: close_pipeline(torch, x.pop("pipeline"))
             for name, x in (("slice", sl), ("slice_int8", sl8), ("slice_contig", sc))}
    emit("spec_memory", memory_allocated_after_close=freed)
    mtp = mesh_tp_check(torch, dev, weights)
    # the training half of the mesh: its own weights, then the shared ones
    mesh_train = mesh_train_check(torch, dev)
    msp = mesh_sp_check(torch, dev, weights)
    mep = mesh_ep_check(torch, dev, weights)
    dcfg = bench_draft_config(weights["llama_config"])
    draft = {"draft_config": dcfg,
             "draft_params": init_llama(dcfg, torch.Generator(device=dev).manual_seed(SEED + 9),
                                        dev)}
    ss = run_spec_slice(torch, dev, Settings(generator=GeneratorConfig(speculative_k=SPEC_K,
                                                                       **caps)),
                        cut_depth(weights, SPEC_LAYERS), draft)
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
    tier = cut_depth(weights, TIER_LAYERS)
    rep = replica_phases(torch, dev, tier)
    san = sanitize_check(torch, dev, tier, rep["replicas_2"]["lone"])
    cli_check(torch)
    cs = convert_serve_check(torch, dev, weights)
    t_workers = time.perf_counter()
    workers = worker_phases(torch, dev, tier, rep["replicas_2"])
    emit("worker_phases", seconds=time.perf_counter() - t_workers)
    elastic = elastic_check(torch, dev, tier, rep["replicas_2"]["lone"])
    worker_paths = {"replicas_2_process": workers["replicas_2_process"]["launches"],
                    "replicas_2_socket": workers["replicas_2_socket"]["launches"],
                    "remote_worker": {k: sum(w["launches"][k] for w in
                                             workers["remote_worker"]["launches"])
                                      for k in wrappers()}}
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
                              "serve_settings": st["launches"]["paged_attention"],
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
                                 for path in rep_paths},
                              **{path: launches["paged_attention"]
                                 for path, launches in worker_paths.items()},
                              "elastic": elastic["paged_launches"],
                              "sanitize": san["launches"]["paged_attention"],
                              "convert_serve": cs["chats"]["launches"]["paged_attention"],
                              "slice_moe": sm["launches"]["paged_attention"],
                              "profile_moe": pm["launches_counted"]["paged_attention"],
                              "mesh_tp": mtp["launches"]["paged_attention"],
                              "mesh_tp_logits": mtp["logits"]["paged_attention_launches"],
                              "mesh_ep": mep["launches"]["paged_attention"],
                              "mesh_ep_logits": mep["logits"]["paged_attention_launches"],
                              "mesh_sp": msp["serving"]["launches"]["paged_attention"],
                              "mesh_train": mesh_train["dp_tp"]["launches"]["paged_attention"]},
         "launches_by_worker": {
             "replicas_2_process": workers["replicas_2_process"]["launches_by_worker"],
             "replicas_2_socket": [w["launches"] for w in
                                   workers["replicas_2_socket"]["round"]["workers"]],
             "remote_worker": [w["launches"] for w in workers["remote_worker"]["launches"]],
             "elastic": [w["launches"] for w in elastic["worker_windows"]]},
         "device_launches_by_worker": {
             "replicas_2_process": [w["device_launches"] for r in
                                    workers["replicas_2_process"]["rounds"]
                                    for w in r["workers"]],
             "replicas_2_socket": [w["device_launches"] for w in
                                   workers["replicas_2_socket"]["round"]["workers"]],
             "remote_worker": [w["device_launches"] for w in
                               workers["remote_worker"]["launches"]],
             "elastic": [w["device_launches"] for w in elastic["worker_windows"]]},
         "device_launches_replica_tier": {path: family_launches(
             rep[path]["device_launches"], "paged_attention") for path in rep_paths},
         "device_launches_sanitize": family_launches(san["device_launches"], "paged_attention"),
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
         "device_launches_serve_settings": family_launches(st["device_launches"],
                                                           "paged_attention"),
         "device_launches_convert_serve": family_launches(cs["chats"]["device_launches"],
                                                          "paged_attention"),
         "device_launches_profiled_chat": device_launches(profile, "paged_attention"),
         "device_launches_slice_moe": family_launches(sm["device_launches"],
                                                      "paged_attention"),
         "device_launches_mesh_tp": family_launches(mtp["device_launches"], "paged_attention"),
         "device_launches_mesh_ep": family_launches(mep["device_launches"], "paged_attention"),
         "device_launches_mesh_ep_logits": family_launches(
             mep["logits"]["device_launches"], "paged_attention"),
         "device_launches_profile_moe": device_launches(pm, "paged_attention"),
         **{k: paged[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                  "bound_by", "library_ms")},
         "cases": [paged, paged_chat, paged_eval, tp2["paged_attention"]]},
        {"name": "paged_attention_quant", "route": "cuda",
         "source": "sentio_tpu_torch/csrc/paged_attention_quant.cu",
         "replaces": "sentio_tpu/kernels/paged_attention.py:167",
         "launches": sl8["launches"]["paged_attention_quant"],
         "launches_by_path": {"slice_int8": sl8["launches"]["paged_attention_quant"],
                              "service": service["launches"]["paged_attention_quant"],
                              "slice_spec": ss["launches"]["paged_attention_quant"],
                              "spec_int8": spec_int8["launches"]["paged_attention_quant"],
                              "quality_gates_int8":
                                  gates["int8"]["launches"]["paged_attention_quant"],
                              "slice_moe_int8": sm8["launches"]["paged_attention_quant"],
                              "mesh_tp_logits_int8":
                                  mtp["logits_int8"]["paged_attention_quant_launches"],
                              "mesh_ep_logits_int8":
                                  mep["logits_int8"]["paged_attention_quant_launches"],
                              "sanitize_int8": san["launches"]["paged_attention_quant"]},
         "device_launches_sanitize_int8": family_launches(san["device_launches"],
                                                          "paged_attention_quant"),
         "device_launches_quality_gates_int8": family_launches(
             gates["int8"]["device_launches"], "paged_attention_quant"),
         "device_launches": family_launches(sl8["device_launches"], "paged_attention_quant"),
         "device_launches_spec_int8": family_launches(spec_int8["device_launches"],
                                                      "paged_attention_quant"),
         "device_launches_profiled_chat": device_launches(profile8, "paged_attention_quant"),
         "device_launches_slice_moe_int8": family_launches(sm8["device_launches"],
                                                           "paged_attention_quant"),
         **{k: paged_quant[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
         "device_launches_mesh_tp_logits_int8": family_launches(
             mtp["logits_int8"]["device_launches"], "paged_attention_quant"),
         "device_launches_mesh_ep_logits_int8": family_launches(
             mep["logits_int8"]["device_launches"], "paged_attention_quant"),
         "cases": [paged_quant, paged_quant_chat, paged_quant_eval,
                   tp2["paged_attention_quant"]]},
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
                              "serve_settings": st["launches"]["flash_attention"],
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
                                 for path in rep_paths},
                              "replicas_2_process_router": sum(
                                  r["router_launches"]["flash_attention"]
                                  for r in workers["replicas_2_process"]["rounds"]),
                              "replicas_2_socket_router": workers["replicas_2_socket"][
                                  "round"]["router_launches"]["flash_attention"],
                              "elastic_router": elastic["router_launches"]["flash_attention"],
                              "sanitize": san["launches"]["flash_attention"],
                              "convert_serve": cs["chats"]["launches"]["flash_attention"],
                              "slice_moe": sm["launches"]["flash_attention"],
                              "profile_moe": pm["launches_counted"]["flash_attention"],
                              "slice_moe_int8": sm8["launches"]["flash_attention"],
                              "mesh_tp": mtp["launches"]["flash_attention"],
                              "mesh_sp": msp["serving"]["launches"]["flash_attention"],
                              "mesh_ep": mep["launches"]["flash_attention"],
                              "mesh_train": mesh_train["dp_tp"]["launches"]["flash_attention"]},
         "device_launches": {path: family_launches(x["device_launches"], "flash_attention")
                             for path, x in (("slice", sl), ("slice_int8", sl8),
                                             ("slice_contig", sc), ("service", service),
                                             ("serve_http_ingest", http["ingest"]),
                                             ("serve_http", http["chats"]),
                                             ("serve_settings", st),
                                             ("convert_serve", cs["chats"]),
                                             ("slice_spec", ss),
                                             ("slice_spec_service", spec_service),
                                             ("spec_int8", spec_int8),
                                             ("spec_exact", spec_exact), ("verify_modes", vm),
                                             *((path, rep[path]) for path in rep_paths),
                                             ("slice_moe", sm), ("slice_moe_int8", sm8),
                                             ("mesh_tp", mtp), ("mesh_ep", mep),
                                             ("sanitize", san))},
         "device_launches_eval": {name: family_launches(ev[name]["device_launches"],
                                                        "flash_attention")
                                  for name in ("dense", "hybrid_rerank", "full_paged",
                                               "batched")},
         "device_launches_profiled_chat": {
             path: device_launches(prof, "flash_attention")
             for path, prof in (("slice", profile), ("slice_int8", profile8),
                                ("slice_spec", profile_spec), ("slice_moe", pm))},
         "max_abs_err": max(c["max_abs_err"] for c in flash),
         **{k: main_flash[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
         "cases": [*flash, *tp2["flash_attention"]]},
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
