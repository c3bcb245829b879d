"""Citation-grounded answer generation — the ``LLMGenerator.build_prompt``
/ ``generate`` path of ``sentio_tpu/ops/generator.py``.

Numbered ``[n] Source: … (score …)`` context assembly, the retrieve
template, temperature by mode, and one provider: :class:`EngineProvider`,
which submits the prompt to the generation service over the paged engine
(``USE_PAGED_KV=1``, the default: concurrent chats share one decode batch)
or, with no service, runs the contiguous engine's ``generate`` (through
its ``SpeculativeDecoder`` when a draft is configured, greedy and sampled
alike), as JAX's ``TpuProvider`` does; ``stream`` yields the answer's text
increments over the service's ``generate_stream`` or the contiguous
engine's ``stream``.
A caller's ``deadline_ts`` (absolute ``time.perf_counter()``) reaches the
service's ticket. The echo and OpenAI providers are not part of this
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence

from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.prompts import PromptBuilder


@dataclass
class EngineProvider:
    """Chat over the in-process engine. ``engine`` is the paged engine that
    ``service`` drives, or, with no service, the contiguous
    ``GeneratorEngine``, whose chats go through ``speculative`` when set.
    Nothing falls back: a service's ``error`` result raises, as in JAX with
    no contiguous engine behind the service."""

    engine: object
    service: object = None  # PagedGenerationService
    # SpeculativeDecoder over the contiguous engine: greedy chats give the
    # engine's tokens, sampled ones the target's law
    speculative: object = None
    name: str = "torch"

    def chat(self, prompt: str, max_new_tokens: int, temperature: float,
             deadline_ts: Optional[float] = None, stats: Optional[dict] = None) -> str:
        if self.service is not None:
            result = self.service.generate(prompt, max_new_tokens=max_new_tokens,
                                           temperature=temperature, deadline_ts=deadline_ts)
            if result.finish_reason == "error":
                raise RuntimeError("paged decode failed and no contiguous engine")
        else:
            generate = (self.speculative or self.engine).generate
            result = generate([prompt], max_new_tokens=max_new_tokens,
                              temperature=temperature)[0]
        if stats is not None:
            stats.update(result.stats_dict())
        return result.text

    def stream(self, prompt: str, max_new_tokens: int, temperature: float,
               deadline_ts: Optional[float] = None,
               stats: Optional[dict] = None) -> Iterator[str]:
        """Text increments of one answer. Closing the iterator early
        cancels the service's ticket."""
        if self.service is not None:
            yield from self.service.generate_stream(
                prompt, max_new_tokens=max_new_tokens, temperature=temperature,
                deadline_ts=deadline_ts, stats_out=stats)
            return
        yield from self.engine.stream(prompt, max_new_tokens=max_new_tokens,
                                      temperature=temperature)


@dataclass
class LLMGenerator:
    provider: EngineProvider
    config: GeneratorConfig = field(default_factory=GeneratorConfig)
    prompts: PromptBuilder = field(default_factory=PromptBuilder)

    def prepare_context(self, documents: Sequence[Document]) -> str:
        """Numbered, citation-ready context block: '[n] Source: … (score …)'
        headers + text."""
        if not documents:
            return "(no context documents)"
        blocks = []
        for i, doc in enumerate(documents, start=1):
            source = doc.metadata.get("source") or doc.metadata.get("source_file") or doc.id
            header = f"[{i}] Source: {source} (score {doc.score():.3f})"
            blocks.append(f"{header}\n{doc.content.strip()}")
        return "\n\n".join(blocks)

    def build_prompt(self, query: str, documents: Sequence[Document]) -> str:
        instruction = self.prompts.load("profile")
        context = self.prepare_context(documents)
        return self.prompts.build("retrieve", instruction=instruction, context=context,
                                  query=query)

    def generate(self, query: str, documents: Sequence[Document],
                 mode: Optional[str] = None, temperature: Optional[float] = None,
                 deadline_ts: Optional[float] = None, stats: Optional[dict] = None) -> str:
        prompt = self.build_prompt(query, documents)
        temp = temperature if temperature is not None else self.config.temperature(mode)
        return self.provider.chat(prompt, max_new_tokens=self.config.max_new_tokens,
                                  temperature=temp, deadline_ts=deadline_ts, stats=stats)

    def stream(self, query: str, documents: Sequence[Document], mode: Optional[str] = None,
               temperature: Optional[float] = None, deadline_ts: Optional[float] = None,
               stats: Optional[dict] = None) -> Iterator[str]:
        prompt = self.build_prompt(query, documents)
        temp = temperature if temperature is not None else self.config.temperature(mode)
        yield from self.provider.stream(prompt, max_new_tokens=self.config.max_new_tokens,
                                        temperature=temp, deadline_ts=deadline_ts,
                                        stats=stats)

    def chat_raw(self, prompt: str, max_new_tokens: int, temperature: float,
                 deadline_ts: Optional[float] = None) -> str:
        """Direct provider access (the verifier path — shares the weights)."""
        return self.provider.chat(prompt, max_new_tokens=max_new_tokens,
                                  temperature=temperature, deadline_ts=deadline_ts)
