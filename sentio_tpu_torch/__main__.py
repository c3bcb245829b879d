"""``python -m sentio_tpu_torch {chat,serve,ingest,eval,train-encoder,trace,info,convert}``

* ``chat "question" [--docs FILE ...]`` builds the ``/chat`` pipeline,
  ingests the given files (a few built-in passages when none are given)
  through the ingestor's readers and chunker, answers the question and
  prints the response as JSON. The generation service is warmed up first,
  as the server does at start-up (on the card: every decode graph
  captured).
* ``serve [--host H] [--port P] [--index PATH]`` runs the HTTP server
  (``/chat`` with SSE, ``/embed``, ``/upload``, ``/clear``, ``/health``,
  ``/info``, ``/metrics``, ``/metrics/performance``, ``/debug/flight``,
  ``/debug/profile``), loading a dense index saved by ``ingest
  --save``; it prints the address it listens on and stops on SIGINT or
  SIGTERM.
* ``ingest PATH [--no-recursive] [--save PATH]`` chunks, embeds and
  indexes a file or a directory, prints the ingest stats as JSON (exit 1
  if a file failed) and saves the dense index.
* ``eval`` runs the eval matrix (``eval/runner.py``: the five
  configurations over the seeded bundle and the loopback baseline) and
  prints the payload as JSON (``--out`` writes it too); JAX's flags and
  defaults (``--scale bench``, 1,024 documents, 64 queries, concurrency 8,
  48 new tokens).
* ``train-encoder OUT`` trains the bi-encoder in-tree
  (``eval/train_encoder.py``; 600 steps of 64 pairs, dim 256, 4 layers by
  default), saves the checkpoint to ``OUT`` (for ``EMBEDDER_CHECKPOINT``
  and ``eval --encoder-checkpoint``) and prints its history as JSON, with
  recall@10 on the eval bundle under ``--eval-recall``.
* ``trace QUERY [--index PATH] [--ingest PATH] [--mode M] [--documents]
  [--chrome FILE]`` runs one question through the pipeline and prints the
  execution trace as JSON (JAX's keys: the stages' path and times, the
  document counts, the answer, the verdict, the metadata, and the request's
  flight record with its engine section and tick window); ``--chrome``
  writes the recorder's whole timeline as a Chrome / Perfetto trace;
  with ``--fleet`` every worker replica's flight buffer is fetched and the
  fleet laid out on the router's clock, a lane per worker incarnation
  (a retired or dead one marked; thread mode falls back to the local
  timeline).
* ``info`` prints the version, the devices (``{"platform": "gpu", "kind":
  <the card's name>}``, or ``cpu``), the retrieval strategy, the
  generator preset and the mesh sizes.

* ``convert {llama,moe,encoder,cross-encoder} SRC DST [--dtype D]`` reads
  a Hugging Face checkpoint directory (``config.json`` and
  ``*.safetensors`` or ``pytorch_model*.bin``) and writes a ``save_pytree``
  checkpoint with the family and config in its meta (``bfloat16`` by
  default), then prints ``{"family", "dst", "config"}`` as JSON, as the JAX
  CLI's ``convert``; it runs on the host and touches no card.

The others run on the card unless ``--device cpu``. Settings come from the
environment as in the JAX service: ``RETRIEVAL_STRATEGY`` (``hybrid`` by
default, or ``dense`` / ``bm25``), ``KV_QUANT=int8`` for an int8 KV page
pool, ``PREFIX_CACHE``, ``DECODE_PIPELINE_DEPTH`` and ``PREFILL_CHUNK``
for the engine, ``USE_PAGED_KV=0`` for the contiguous engine,
``LLM_CHECKPOINT`` / ``RERANKER_CHECKPOINT`` / ``EMBEDDER_CHECKPOINT`` for
``save_pytree`` checkpoints (``convert``'s), each with its own Hugging Face
tokenizer directory in ``LLM_TOKENIZER`` / ``RERANKER_TOKENIZER`` /
``EMBEDDER_TOKENIZER``, ``LLM_PROVIDER`` / ``EMBEDDER_PROVIDER`` /
``RERANKER_KIND`` as in JAX's container, ``CHUNK_SIZE``, ``INDEX_PATH``,
``SENTIO_PORT`` and the rest of ``sentio_tpu_torch.config``. Weights not
loaded from a checkpoint are random, made from ``--seed`` (``ingest`` and
``serve`` with the same seed embed with the same weights). ``--tiny``
swaps in the CPU-test presets of every model.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from dataclasses import replace

SAMPLE_PASSAGES = (
    "The paged KV cache stores keys and values in fixed-size pages; each "
    "sequence owns a page table that maps its logical blocks to pages.",
    "Continuous batching admits new requests into free decode slots at tick "
    "boundaries instead of waiting for the whole batch to finish.",
    "A cross-encoder scores a query and a passage together, which ranks "
    "candidates more precisely than comparing separate embeddings.",
    "Exact maximum inner product search scores the query against every "
    "corpus vector with one matrix product and keeps the top k.",
)


def _settings(args):
    from sentio_tpu_torch.config import Settings

    settings = Settings.from_env()
    if args.tiny:
        settings.embedder = replace(settings.embedder, model_preset="tiny")
        settings.generator = replace(settings.generator, model_preset="tiny",
                                     kv_page_size=16, kv_max_pages_per_seq=64)
    if getattr(args, "max_tokens", None) is not None:
        settings.generator = replace(settings.generator, max_new_tokens=args.max_tokens,
                                     verifier_max_tokens=args.max_tokens)
    return settings


def _cmd_chat(args) -> int:
    from sentio_tpu_torch.models.document import Document
    from sentio_tpu_torch.pipeline import build_pipeline

    pipeline = build_pipeline(_settings(args), device=args.device, seed=args.seed)
    try:
        pipeline.warmup()
        ingestor = pipeline.ingestor
        docs = [doc for path in args.docs for doc in ingestor.load_file(path)]
        if not docs:
            docs = [Document(text=t, metadata={"source": f"sample-{i}"})
                    for i, t in enumerate(SAMPLE_PASSAGES)]
        ingestor.ingest_documents(docs)
        response = pipeline.chat(args.question)
    finally:
        pipeline.close()
    json.dump(response, sys.stdout, indent=1)
    sys.stdout.write("\n")
    return 0


def _cmd_serve(args) -> int:
    from sentio_tpu_torch.serve.app import run_server

    settings = _settings(args)
    if args.host:
        settings.serve = replace(settings.serve, host=args.host)
    if args.port is not None:
        settings.serve = replace(settings.serve, port=args.port)
    if args.index:
        settings.retrieval = replace(settings.retrieval, index_path=args.index)
    run_server(settings, device=args.device, seed=args.seed)
    return 0


def _cmd_ingest(args) -> int:
    from sentio_tpu_torch.ops.dense_index import TorchDenseIndex
    from sentio_tpu_torch.ops.ingest import DocumentIngestor
    from sentio_tpu_torch.pipeline import make_embedder

    settings = _settings(args)
    embedder = make_embedder(settings, args.device, args.seed)
    index = TorchDenseIndex(embedder.dimension, device=embedder.device,
                            dtype=settings.generator.dtype)
    ingestor = DocumentIngestor(embedder=embedder, dense_index=index, settings=settings)
    try:
        stats = ingestor.ingest_path(args.path, recursive=not args.no_recursive)
    finally:
        embedder.close()
    if args.save:
        index.save(args.save)
        print(f"index saved to {args.save}", file=sys.stderr)
    print(json.dumps(stats.to_dict()))
    return 0 if not stats.errors else 1


def _cmd_trace(args) -> int:
    import uuid

    from sentio_tpu_torch.infra.flight import get_flight_recorder
    from sentio_tpu_torch.pipeline import build_pipeline, wait_detached

    settings = _settings(args)
    pipeline = build_pipeline(settings, device=args.device, seed=args.seed)
    try:
        if args.index:
            pipeline.load_index(args.index)
        if args.ingest:
            pipeline.ingestor.ingest_path(args.ingest)
        query_id = f"trace-{uuid.uuid4().hex[:8]}"
        state = pipeline.run(args.query, mode=args.mode,
                             metadata={"mode": args.mode, "query_id": query_id})
        # a detached verify: wait for its verdict to land on the record
        if state["metadata"].get("verify_pending"):
            wait_detached()
        meta = state["metadata"]
        trace = {
            "query": args.query,
            "request_id": query_id,
            "graph_path": meta.get("graph_path"),
            "node_timings_ms": meta.get("node_timings_ms"),
            "num_retrieved": len(state.get("retrieved_documents") or []),
            "num_reranked": len(state.get("reranked_documents") or []),
            "num_selected": len(state.get("selected_documents") or []),
            "answer": state.get("response"),
            "evaluation": state.get("evaluation") or None,
            "metadata": {k: v for k, v in meta.items()
                         if k not in ("graph_path", "node_timings_ms")},
        }
        flight = get_flight_recorder().get(query_id)
        if flight is not None:
            trace["flight"] = {k: v for k, v in flight.items()
                               if k not in ("node_timings_ms", "graph_path", "request_id")}
        if args.chrome:
            from sentio_tpu_torch.infra.chrome_trace import flight_to_chrome

            chrome = _fleet_trace(pipeline) if args.fleet else None
            if chrome is None:
                if args.fleet:
                    print("--fleet: no worker replicas (thread mode?) — falling back to the "
                          "local timeline", file=sys.stderr)
                chrome = flight_to_chrome()
            with open(args.chrome, "w") as fh:
                json.dump(chrome, fh)
            print(f"chrome trace written to {args.chrome} (open in ui.perfetto.dev)",
                  file=sys.stderr)
        if args.documents:
            trace["selected_documents"] = [
                {"id": d.id, "text": d.text[:200], "metadata": d.metadata}
                for d in (state.get("selected_documents") or [])]
    finally:
        pipeline.close()
    print(json.dumps(trace, indent=2, default=str))
    return 0


def _fleet_trace(pipeline):
    """Every worker replica's flight buffer (``fetch_flight``) on one
    Chrome trace aligned to the router's clock: the router's lanes on top,
    a process row per worker incarnation below, its timestamps shifted by
    its ``ClockSync`` (the lane names the ± bound). A RETIRING or RETIRED
    incarnation, or one that does not answer, keeps its lane from the
    router's cached telemetry, marked ``(retired)`` or ``(dead)``. None
    without worker replicas (thread mode)."""
    from sentio_tpu_torch.infra.chrome_trace import build_fleet_trace
    from sentio_tpu_torch.infra.flight import get_flight_recorder

    rs = pipeline.replica_set
    members = list(getattr(rs, "_services", None) or ())
    healths = list(getattr(rs, "_health", None) or ())
    if not any(callable(getattr(svc, "fetch_flight", None)) for svc in members):
        return None
    recorder = get_flight_recorder()
    router_origin = recorder.origin()
    workers = []
    for idx, svc in enumerate(members):
        if not callable(getattr(svc, "fetch_flight", None)):
            continue
        state = healths[idx].state if idx < len(healths) else ""
        if state in ("RETIRING", "RETIRED"):
            workers.append(svc.cached_flight_lane(router_origin, "retired"))
            continue
        try:
            reply = svc.fetch_flight()
        except Exception as exc:  # noqa: BLE001 — a dead worker: its cached lane
            print(f"--fleet: replica {svc.replica_id} unavailable ({type(exc).__name__}) — "
                  "rendering its lane from cached telemetry", file=sys.stderr)
            workers.append(svc.cached_flight_lane(router_origin, "dead"))
            continue
        shift, bound = svc.flight_shift_s(router_origin)
        workers.append({"replica": reply.get("replica"), "epoch": reply.get("epoch") or 0,
                        "shift_s": shift, "uncertainty_s": bound,
                        "ticks": reply.get("ticks") or [],
                        "records": reply.get("records") or []})
    return build_fleet_trace(workers, router_ticks=recorder.timeline(),
                             router_records=recorder.records())


def _cmd_info(args) -> int:
    import torch

    from sentio_tpu_torch import __version__, resolve_device

    settings = _settings(args)
    if resolve_device(args.device).type == "cuda":
        devices = [{"platform": "gpu", "kind": torch.cuda.get_device_name(i)}
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [{"platform": "cpu", "kind": "cpu"}]
    print(json.dumps({
        "version": __version__,
        "devices": devices,
        "retrieval": settings.retrieval.strategy,
        "generator": settings.generator.model_preset,
        "mesh": {"dp": settings.mesh.dp_size, "tp": settings.mesh.tp_size,
                 "sp": settings.mesh.sp_size},
    }, indent=2))
    return 0


def _cmd_eval(args) -> int:
    from sentio_tpu_torch.eval.runner import run_eval

    payload = run_eval(
        scale=args.scale, n_docs=args.docs, n_queries=args.queries,
        concurrency=args.concurrency, new_tokens=args.new_tokens, rtt_ms=args.rtt_ms,
        seed=args.seed, skip_baseline=args.skip_baseline,
        configs={c.strip() for c in args.configs.split(",") if c.strip()} or None,
        encoder_checkpoint=args.encoder_checkpoint, kv_quant=args.kv_quant,
        device=args.device)
    text = json.dumps(payload, indent=2)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
        print(f"wrote {args.out}", file=sys.stderr)
    print(text)
    return 0


def _cmd_train_encoder(args) -> int:
    from sentio_tpu_torch.eval.train_encoder import TrainConfig, eval_recall, train_encoder
    from sentio_tpu_torch.models.transformer import EncoderConfig

    enc_cfg = EncoderConfig(vocab_size=512, dim=args.dim, n_layers=args.layers,
                            n_heads=max(args.dim // 64, 2), mlp_dim=args.dim * 4, max_len=512)
    params, enc_cfg, history = train_encoder(
        enc_cfg=enc_cfg, train_cfg=TrainConfig(steps=args.steps, batch=args.batch, lr=args.lr),
        out_path=args.out, seed=args.seed, device=args.device)
    history.pop("step_ms")
    payload = {"checkpoint": args.out, "history": history}
    if args.eval_recall:
        payload["recall_at_10"] = round(eval_recall(params, enc_cfg, device=args.device), 3)
    print(json.dumps(payload))
    return 0


def _cmd_convert(args) -> int:
    """A local HF checkpoint directory → a ``save_pytree`` checkpoint."""
    from sentio_tpu_torch.models.convert import load_family_dir
    from sentio_tpu_torch.runtime.weights import save_pytree

    params, cfg = load_family_dir(args.family, args.src, dtype=args.dtype)
    save_pytree(args.dst, params, meta={"family": args.family, "config": cfg.__dict__})
    print(json.dumps({"family": args.family, "dst": args.dst, "config": cfg.__dict__}))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sentio_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p) -> None:
        p.add_argument("--device", default=None, help="default: cuda")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--tiny", action="store_true", help="CPU-test model presets")

    chat = sub.add_parser("chat", help="answer one question through the pipeline")
    chat.add_argument("question")
    chat.add_argument("--docs", nargs="*", default=[], help="files to ingest")
    chat.add_argument("--max-tokens", type=int, default=None,
                      help="cap on answer and verify tokens (LLM_MAX_TOKENS)")
    common(chat)
    chat.set_defaults(fn=_cmd_chat)

    serve = sub.add_parser("serve", help="run the HTTP server")
    serve.add_argument("--host", default="")
    serve.add_argument("--port", type=int, default=None, help="0 picks a free port")
    serve.add_argument("--index", default="",
                       help="load a persisted dense index (from ingest --save)")
    common(serve)
    serve.set_defaults(fn=_cmd_serve)

    ingest = sub.add_parser("ingest", help="ingest a file or directory into the index")
    ingest.add_argument("path")
    ingest.add_argument("--no-recursive", action="store_true")
    ingest.add_argument("--save", default="", help="persist the dense index to this path")
    common(ingest)
    ingest.set_defaults(fn=_cmd_ingest)

    ev = sub.add_parser("eval", help="run the eval matrix and print its payload")
    ev.add_argument("--scale", default="bench", choices=["tiny", "bench"])
    ev.add_argument("--docs", type=int, default=1024)
    ev.add_argument("--queries", type=int, default=64)
    ev.add_argument("--concurrency", type=int, default=8)
    ev.add_argument("--new-tokens", type=int, default=48)
    ev.add_argument("--rtt-ms", type=float, default=0.0,
                    help="per-hop delay of the loopback baseline's model APIs")
    ev.add_argument("--seed", type=int, default=0)
    ev.add_argument("--skip-baseline", action="store_true")
    ev.add_argument("--configs", default="",
                    help="comma list: sparse_api,dense,hybrid_rerank,full_paged,batched")
    ev.add_argument("--out", default="", help="also write the JSON here")
    ev.add_argument("--kv-quant", default=os.environ.get("KV_QUANT", "none"),
                    choices=["none", "int8"], help="KV page quantization of the paged configs")
    ev.add_argument("--encoder-checkpoint", default="",
                    help="trained bi-encoder checkpoint for the dense leg (train-encoder)")
    ev.add_argument("--device", default=None, help="default: cuda")
    ev.set_defaults(fn=_cmd_eval)

    tr = sub.add_parser("train-encoder", help="train the bi-encoder on the synthetic bundle")
    tr.add_argument("out", help="checkpoint output directory")
    tr.add_argument("--steps", type=int, default=600)
    tr.add_argument("--batch", type=int, default=64)
    tr.add_argument("--lr", type=float, default=3e-4)
    tr.add_argument("--dim", type=int, default=256)
    tr.add_argument("--layers", type=int, default=4)
    tr.add_argument("--seed", type=int, default=0)
    tr.add_argument("--eval-recall", action="store_true",
                    help="measure recall@10 on the eval bundle (seed 0) after training")
    tr.add_argument("--device", default=None, help="default: cuda")
    tr.set_defaults(fn=_cmd_train_encoder)

    trace = sub.add_parser("trace", help="run one query and print its execution trace")
    trace.add_argument("query")
    trace.add_argument("--ingest", default="", help="ingest this path first")
    trace.add_argument("--index", default="", help="load a persisted dense index")
    trace.add_argument("--mode", default="balanced",
                       choices=["fast", "balanced", "quality", "creative"])
    trace.add_argument("--documents", action="store_true",
                       help="include the selected documents in the output")
    trace.add_argument("--chrome", default="", metavar="OUT_JSON",
                       help="also write the flight timeline as a Chrome/Perfetto trace")
    trace.add_argument("--fleet", action="store_true",
                       help="with --chrome: every worker replica's flight buffer on one "
                            "clock-aligned trace (a lane per worker incarnation)")
    common(trace)
    trace.set_defaults(fn=_cmd_trace)

    conv = sub.add_parser("convert", help="convert a local HF checkpoint dir")
    conv.add_argument("family", choices=["llama", "moe", "encoder", "cross-encoder"])
    conv.add_argument("src", help="HF checkpoint directory (config.json + weights)")
    conv.add_argument("dst", help="output framework checkpoint directory")
    conv.add_argument("--dtype", default="bfloat16")
    conv.set_defaults(fn=_cmd_convert)

    info = sub.add_parser("info", help="print version, device and config info")
    common(info)
    info.set_defaults(fn=_cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
