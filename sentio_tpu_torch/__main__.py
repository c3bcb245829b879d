"""``python -m sentio_tpu_torch {chat,serve,ingest}``

* ``chat "question" [--docs FILE ...]`` builds the ``/chat`` pipeline,
  ingests the given files (a few built-in passages when none are given)
  through the ingestor's readers and chunker, answers the question and
  prints the response as JSON. The generation service is warmed up first,
  as the server does at start-up (on the card: every decode graph
  captured).
* ``serve [--host H] [--port P] [--index PATH]`` runs the HTTP server
  (``/chat`` with SSE, ``/embed``, ``/upload``, ``/clear``, ``/health``,
  ``/info``, ``/metrics``), loading a dense index saved by ``ingest
  --save``; it prints the address it listens on and stops on SIGINT or
  SIGTERM.
* ``ingest PATH [--no-recursive] [--save PATH]`` chunks, embeds and
  indexes a file or a directory, prints the ingest stats as JSON (exit 1
  if a file failed) and saves the dense index.

Each runs on the card unless ``--device cpu``. Settings come from the
environment as in the JAX service: ``RETRIEVAL_STRATEGY`` (``hybrid`` by
default, or ``dense`` / ``bm25``), ``KV_QUANT=int8`` for an int8 KV page
pool, ``PREFIX_CACHE``, ``DECODE_PIPELINE_DEPTH`` and ``PREFILL_CHUNK``
for the engine, ``USE_PAGED_KV=0`` for the contiguous engine,
``LLM_CHECKPOINT`` / ``RERANKER_CHECKPOINT`` / ``EMBEDDER_CHECKPOINT`` for
``save_pytree`` checkpoints, ``CHUNK_SIZE``, ``INDEX_PATH``,
``SENTIO_PORT`` and the rest of ``sentio_tpu_torch.config``. Weights not
loaded from a checkpoint are random, made from ``--seed`` (``ingest`` and
``serve`` with the same seed embed with the same weights). ``--tiny``
swaps in the CPU-test presets of every model.
"""

from __future__ import annotations

import argparse
import json
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

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
