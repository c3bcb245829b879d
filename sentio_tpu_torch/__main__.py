"""``python -m sentio_tpu_torch chat "question" [--docs FILE ...]``

Builds the ``/chat`` pipeline on the card (or ``--device cpu``), ingests the
given text files cut into ~512-character chunks (a few built-in passages
when none are given), answers the question and prints the response as
JSON. Settings come from the environment as in the JAX service:
``RETRIEVAL_STRATEGY`` (``hybrid`` by default, or ``dense`` / ``bm25``),
``KV_QUANT=int8`` for an int8 KV page pool, ``PREFIX_CACHE``,
``DECODE_PIPELINE_DEPTH`` and ``PREFILL_CHUNK`` for the engine,
``USE_PAGED_KV=0`` for the contiguous engine, ``LLM_CHECKPOINT`` /
``RERANKER_CHECKPOINT`` / ``EMBEDDER_CHECKPOINT`` for ``save_pytree``
checkpoints, and the rest of ``sentio_tpu_torch.config``. Weights not
loaded from a checkpoint are random, made from ``--seed``. The generation
service is warmed up before the question, as the JAX server does at
start-up (on the card: every decode graph captured). ``--tiny`` swaps in
the CPU-test presets of every model.
"""

from __future__ import annotations

import argparse
import json
import sys
from dataclasses import replace
from pathlib import Path

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


def _chunks(text: str, size: int = 512) -> list[str]:
    text = " ".join(text.split())
    return [text[i : i + size] for i in range(0, len(text), size)] or [""]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m sentio_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    chat = sub.add_parser("chat", help="answer one question through the pipeline")
    chat.add_argument("question")
    chat.add_argument("--docs", nargs="*", default=[], help="text files to ingest")
    chat.add_argument("--max-tokens", type=int, default=None,
                      help="cap on answer and verify tokens (LLM_MAX_TOKENS)")
    chat.add_argument("--device", default=None, help="default: cuda")
    chat.add_argument("--seed", type=int, default=0)
    chat.add_argument("--tiny", action="store_true", help="CPU-test model presets")
    args = parser.parse_args(argv)

    from sentio_tpu_torch.config import Settings
    from sentio_tpu_torch.models.document import Document
    from sentio_tpu_torch.pipeline import build_pipeline

    settings = Settings.from_env()
    if args.tiny:
        settings.embedder = replace(settings.embedder, model_preset="tiny")
        settings.generator = replace(settings.generator, model_preset="tiny",
                                     kv_page_size=16, kv_max_pages_per_seq=64)
    if args.max_tokens is not None:
        settings.generator = replace(settings.generator, max_new_tokens=args.max_tokens,
                                     verifier_max_tokens=args.max_tokens)
    pipeline = build_pipeline(settings, device=args.device, seed=args.seed)
    pipeline.warmup()

    texts = [(Path(p).name, Path(p).read_text()) for p in args.docs]
    if not texts:
        texts = [(f"sample-{i}", t) for i, t in enumerate(SAMPLE_PASSAGES)]
    docs = [Document(text=chunk, metadata={"source": name})
            for name, text in texts for chunk in _chunks(text)]
    pipeline.ingest(docs)
    try:
        response = pipeline.chat(args.question)
    finally:
        pipeline.close()
    json.dump(response, sys.stdout, indent=1)
    sys.stdout.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
