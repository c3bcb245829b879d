"""Host services over the models: embedder, index, reranker, prompts, generator, verifier."""
