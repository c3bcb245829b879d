"""Citation-grounded answer generation — the ``LLMGenerator.build_prompt``
/ ``generate`` path of ``sentio_tpu/ops/generator.py``.

Numbered ``[n] Source: … (score …)`` context assembly, the retrieve
template, temperature by mode, and one provider: :class:`EngineProvider`,
JAX's ``TpuProvider``, which submits the prompt to the replica tier over
the paged engines (``USE_PAGED_KV=1``, the default: concurrent chats share
one decode batch) with the contiguous engine behind it as the escape
hatch, or, with no tier, runs the contiguous engine's ``generate``
(through its ``SpeculativeDecoder`` when a draft is configured, greedy and
sampled alike); ``stream`` yields the answer's text increments over the
tier's ``generate_stream`` or the contiguous engine's ``stream``.
A caller's ``deadline_ts`` (absolute ``time.perf_counter()``) reaches the
service's ticket, and so do the request's flight-record id
(``request_id``), its WFQ ``tenant`` and ``priority`` and a stream's
``resumable=False`` opt-out, which the replica tier in front of the paged
engines reads.

:class:`OpenAIProvider` is JAX's OpenAI-compatible remote provider on the
standard library (``infra/http_client.py``: one keep-alive connection per
thread, as its ``httpx.Client`` pools them): retries with backoff, the
``/api/v1`` → ``/v1`` fallback on a 404, SSE streaming that falls back to
one plain call, and the last call's token usage. The eval's ``sparse_api``
configuration answers through it. :class:`EchoProvider` is JAX's
deterministic fake that quotes the top source. ``LLM_PROVIDER`` picks one
as JAX's ``create_generator`` does (:func:`provider_for`): ``tpu`` the
engines, ``openai`` the remote endpoint, any other name the registry's
(``echo``), or JAX's ``ValueError``.
"""

from __future__ import annotations

import json
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional, Sequence
from urllib.parse import urlsplit, urlunsplit

from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.infra.http_client import HttpClient
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.prompts import PromptBuilder


@dataclass
class EngineProvider:
    """Chat over the in-process engines, by ``TpuProvider``'s rules: through
    ``service``, the replica tier over paged engines, with the contiguous
    ``GeneratorEngine`` ``contiguous`` as the escape hatch — a chat is
    answered by it after the tier gives an ``error`` result or raises
    anything not ``soft_fail_exempt`` (a shed, an expired deadline or a
    replica the tier gave up on re-raise: the caller gave up or the load
    was being protected), a stream only while it has yielded nothing
    (after that a restart would repeat the answer); with no contiguous
    engine those raise. The escape hatch is the plain contiguous engine,
    never ``speculative`` (JAX builds no decoder beside paged engines).
    With no service, chats go to the contiguous engine, through
    ``speculative`` when set. ``routing`` (``request_id``, ``tenant``,
    ``priority``, a stream's ``resumable``) goes to the tier as given; the
    contiguous engine has no tier to take it."""

    contiguous: object = None
    service: object = None  # ReplicaSet
    # SpeculativeDecoder over the contiguous engine: greedy chats give the
    # engine's tokens, sampled ones the target's law
    speculative: object = None
    name: str = "torch"

    @property
    def engine(self):
        """The contiguous engine, or the first replica's current paged
        engine (a rebuild replaces it)."""
        return self.service.services[0].engine if self.service is not None \
            else self.contiguous

    def chat(self, prompt: str, max_new_tokens: int, temperature: float,
             deadline_ts: Optional[float] = None, stats: Optional[dict] = None,
             **routing) -> str:
        if self.service is not None:
            try:
                result = self.service.generate(prompt, max_new_tokens=max_new_tokens,
                                               temperature=temperature,
                                               deadline_ts=deadline_ts, **routing)
                if result.finish_reason != "error":
                    if stats is not None:
                        stats.update(result.stats_dict())
                    return result.text
            except Exception as exc:  # noqa: BLE001 — the contiguous engine is the escape hatch
                if getattr(exc, "soft_fail_exempt", False) or self.contiguous is None:
                    raise
            if self.contiguous is None:
                raise RuntimeError("paged decode failed and no contiguous engine")
            return self.contiguous.generate([prompt], max_new_tokens=max_new_tokens,
                                            temperature=temperature)[0].text
        generate = (self.speculative or self.contiguous).generate
        result = generate([prompt], max_new_tokens=max_new_tokens,
                          temperature=temperature)[0]
        if stats is not None:
            stats.update(result.stats_dict())
        return result.text

    def stream(self, prompt: str, max_new_tokens: int, temperature: float,
               deadline_ts: Optional[float] = None, stats: Optional[dict] = None,
               **routing) -> Iterator[str]:
        """Text increments of one answer. Closing the iterator early
        cancels the tier's ticket."""
        if self.service is not None:
            yielded = False
            try:
                for piece in self.service.generate_stream(
                        prompt, max_new_tokens=max_new_tokens, temperature=temperature,
                        deadline_ts=deadline_ts, stats_out=stats, **routing):
                    yielded = True
                    yield piece
                return
            except Exception as exc:  # noqa: BLE001 — the contiguous engine is the escape hatch
                if yielded or self.contiguous is None \
                        or getattr(exc, "soft_fail_exempt", False):
                    raise
        yield from self.contiguous.stream(prompt, max_new_tokens=max_new_tokens,
                                          temperature=temperature)


@dataclass
class EchoProvider:
    """Deterministic fake — ``sentio_tpu/ops/generator.py::EchoProvider``:
    answers by quoting the top source, with no model and no device."""

    name: str = "echo"

    def chat(self, prompt: str, max_new_tokens: int, temperature: float,
             deadline_ts: Optional[float] = None, stats: Optional[dict] = None) -> str:
        line = ""
        for cand in prompt.splitlines():
            if cand.strip().startswith("[1]"):
                line = cand.strip()
                break
        if line:
            return f"Based on the provided sources, the most relevant finding is: {line}"
        return "No sources were provided, so no grounded answer is available."

    def stream(self, prompt: str, max_new_tokens: int, temperature: float,
               deadline_ts: Optional[float] = None,
               stats: Optional[dict] = None) -> Iterator[str]:
        text = self.chat(prompt, max_new_tokens, temperature)
        for i in range(0, len(text), 16):
            yield text[i: i + 16]


@dataclass
class OpenAIProvider:
    """OpenAI-compatible remote chat provider — ``sentio_tpu/ops/
    generator.py::OpenAIProvider``: ``{base_url}/chat/completions`` with
    bearer auth, up to ``max_retries`` retries of transport errors, 5xx and
    429 (4xx fail at once), and SSE streaming."""

    base_url: str = "http://127.0.0.1:8000/v1"
    api_key: str = ""
    model: str = "default"
    timeout_s: float = 60.0
    max_retries: int = 2
    name: str = "openai"
    # the endpoint's (or a local count of) token usage of the last
    # successful chat(); empty before the first call
    last_usage: dict = field(default_factory=dict)
    # guards base_url switches and the client bookkeeping: chat() runs on
    # concurrent threads, and racing 404 fallbacks must not flap base_url
    # or strand a client unclosed
    _lock: threading.Lock = field(default_factory=threading.Lock, init=False, repr=False,
                                  compare=False)
    _client_cached: Optional[HttpClient] = field(default=None, init=False, repr=False,
                                                 compare=False)
    _retired_clients: list = field(default_factory=list, init=False, repr=False,
                                   compare=False)

    def _client(self) -> HttpClient:
        """One client per provider and base URL, reused across calls and
        retries; built under the lock so two racing first calls build one."""
        with self._lock:
            if self._client_cached is None:
                headers = {"Authorization": f"Bearer {self.api_key}"} if self.api_key else {}
                self._client_cached = HttpClient(self.base_url, timeout=self.timeout_s,
                                                 headers=headers)
            return self._client_cached

    def close(self) -> None:
        with self._lock:
            doomed = [c for c in (self._client_cached,) if c is not None]
            doomed += self._retired_clients
            self._client_cached, self._retired_clients = None, []
        for client in doomed:
            client.close()

    def _payload(self, prompt: str, max_new_tokens: int, temperature: float) -> dict:
        return {"model": self.model, "messages": [{"role": "user", "content": prompt}],
                "max_tokens": max_new_tokens, "temperature": temperature}

    def _alt_base(self) -> Optional[str]:
        """A base whose path holds ``/api`` gets one retry without it after
        a 404 (``…/api/v1`` against ``…/v1`` deployments); only the path is
        rewritten."""
        parts = urlsplit(self.base_url)
        if "/api/" in parts.path or parts.path.endswith("/api"):
            return urlunsplit(parts._replace(path=parts.path.replace("/api", "", 1)))
        return None

    def _switch_base(self, new_base: str, only_from: Optional[str] = None) -> bool:
        """Rebind the base URL without closing the old client (other threads
        may have calls in flight on it; it is closed by :meth:`close`).
        Compare-and-swap: with ``only_from``, switch only while ``base_url``
        still holds it. Returns whether this call switched."""
        with self._lock:
            if only_from is not None and self.base_url != only_from:
                return False
            if self.base_url == new_base:
                return False
            if self._client_cached is not None:
                self._retired_clients.append(self._client_cached)
                self._client_cached = None
            self.base_url = new_base
            return True

    @staticmethod
    def count_tokens(text: str) -> int:
        """A words × 4/3 token estimate, for an endpoint that reports no
        ``usage``."""
        return max(int(len(text.split()) * 4 / 3), 1)

    def _note_usage(self, body: dict, prompt: str, reply: str, latency_s: float) -> None:
        """The call's token usage (as reported, else counted) into
        ``last_usage``, and the call into ``/metrics`` (``remote_chat``)."""
        from sentio_tpu_torch.infra.metrics import get_metrics

        usage = body.get("usage") or {}
        completion = usage.get("completion_tokens")
        if completion is None:
            completion = self.count_tokens(reply)
        prompt_tokens = usage.get("prompt_tokens")
        if prompt_tokens is None:
            prompt_tokens = self.count_tokens(prompt)
        self.last_usage = {"prompt_tokens": int(prompt_tokens),
                           "completion_tokens": int(completion)}
        get_metrics().record_llm("remote_chat", latency_s, tokens=int(completion))

    def chat(self, prompt: str, max_new_tokens: int, temperature: float,
             deadline_ts: Optional[float] = None, stats: Optional[dict] = None) -> str:
        payload = self._payload(prompt, max_new_tokens, temperature)
        last_exc: Optional[Exception] = None
        for attempt in range(self.max_retries + 1):
            try:
                t0 = time.perf_counter()
                resp = self._client().post("/chat/completions", payload)
                if resp.status_code == 404 and not resp.url.startswith(
                        self.base_url.rstrip("/")):
                    # raced another thread's fallback switch: this 404 came
                    # from the retired base, so ask the current one
                    resp = self._client().post("/chat/completions", payload)
                alt = self._alt_base() if resp.status_code == 404 else None
                if alt:
                    old = self.base_url
                    switched = self._switch_base(alt, only_from=old)
                    try:
                        resp = self._client().post("/chat/completions", payload)
                    except Exception:
                        # the probe failed before any status: keep the
                        # configured base (if this call switched it)
                        if switched:
                            self._switch_base(old, only_from=alt)
                        raise
                    if resp.status_code >= 400 and switched:
                        self._switch_base(old, only_from=alt)
                resp.raise_for_status()
                body = resp.json()
                reply = body["choices"][0]["message"]["content"]
                self._note_usage(body, prompt, reply, time.perf_counter() - t0)
                return reply
            except Exception as exc:  # noqa: BLE001 — retry transport errors, 5xx, 429
                status = getattr(getattr(exc, "response", None), "status_code", None)
                if status is not None and 400 <= status < 500 and status != 429:
                    raise  # auth and configuration errors do not heal
                last_exc = exc
                if attempt < self.max_retries:
                    time.sleep(min(2.0 ** attempt, 4.0) * (0.5 + random.random() / 2))
        raise RuntimeError(f"openai provider failed after {self.max_retries + 1} attempts"
                           ) from last_exc

    def stream(self, prompt: str, max_new_tokens: int, temperature: float,
               deadline_ts: Optional[float] = None,
               stats: Optional[dict] = None) -> Iterator[str]:
        """SSE (``data: {...}`` lines, ``[DONE]``); an endpoint that answers
        ``stream=True`` with one JSON completion, or rejects it, gets one
        plain call instead."""
        payload = {**self._payload(prompt, max_new_tokens, temperature), "stream": True}
        saw_sse = False
        try:
            body_lines: list[str] = []
            for line in self._client().stream_lines("/chat/completions", payload):
                if not line.startswith("data:"):
                    body_lines.append(line)
                    continue
                saw_sse = True
                data = line[len("data:"):].strip()
                if data == "[DONE]":
                    return
                try:
                    delta = json.loads(data)["choices"][0]["delta"]
                except (KeyError, IndexError, ValueError):
                    continue
                if delta.get("content"):
                    yield delta["content"]
            if not saw_sse:
                reply = json.loads("\n".join(body_lines))
                yield reply["choices"][0]["message"]["content"]
        except Exception:  # noqa: BLE001 — endpoints without SSE support
            if saw_sse:
                raise  # a stream broken mid-answer must not pass as complete
            yield self.chat(prompt, max_new_tokens, temperature)

    @classmethod
    def from_config(cls, cfg: GeneratorConfig) -> "OpenAIProvider":
        return cls(base_url=cfg.api_base or cls.base_url, api_key=cfg.api_key,
                   model=cfg.api_model or cls.model, timeout_s=cfg.api_timeout_s)


_PROVIDERS = {"echo": EchoProvider, "tpu": EngineProvider, "openai": OpenAIProvider}


def get_provider(name: str, **kwargs):
    """JAX's provider registry."""
    cls = _PROVIDERS.get(name)
    if cls is None:
        raise ValueError(f"unknown LLM provider {name!r}; known: {sorted(_PROVIDERS)}")
    return cls(**kwargs)


def provider_for(cfg: GeneratorConfig):
    """The provider of an ``LLM_PROVIDER`` other than ``tpu``, by JAX's
    ``create_generator``: ``openai`` from the settings, any other name from
    the registry. Nothing of it touches the card."""
    if cfg.provider == "tpu":
        raise ValueError("LLM_PROVIDER=tpu is served by the engines")
    if cfg.provider == "openai":
        return OpenAIProvider.from_config(cfg)
    return get_provider(cfg.provider)


@dataclass
class LLMGenerator:
    provider: object  # EngineProvider, OpenAIProvider or EchoProvider
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

    def _routing(self, tenant: Optional[str], priority: Optional[str],
                 resumable: Optional[bool] = None,
                 request_id: Optional[str] = None) -> dict:
        """The flight-record id and the WFQ and resume kwargs, only when set
        and only for the engine provider (a remote OpenAIProvider has no
        replica tier)."""
        if not isinstance(self.provider, EngineProvider):
            return {}
        out = {k: v for k, v in (("tenant", tenant), ("priority", priority),
                                 ("request_id", request_id)) if v is not None}
        if resumable is False:
            out["resumable"] = False
        return out

    def generate(self, query: str, documents: Sequence[Document],
                 mode: Optional[str] = None, temperature: Optional[float] = None,
                 deadline_ts: Optional[float] = None, stats: Optional[dict] = None,
                 tenant: Optional[str] = None, priority: Optional[str] = None,
                 request_id: Optional[str] = None) -> str:
        prompt = self.build_prompt(query, documents)
        temp = temperature if temperature is not None else self.config.temperature(mode)
        return self.provider.chat(prompt, max_new_tokens=self.config.max_new_tokens,
                                  temperature=temp, deadline_ts=deadline_ts, stats=stats,
                                  **self._routing(tenant, priority, request_id=request_id))

    def stream(self, query: str, documents: Sequence[Document], mode: Optional[str] = None,
               temperature: Optional[float] = None, deadline_ts: Optional[float] = None,
               stats: Optional[dict] = None, tenant: Optional[str] = None,
               priority: Optional[str] = None,
               resumable: Optional[bool] = None,
               request_id: Optional[str] = None) -> Iterator[str]:
        prompt = self.build_prompt(query, documents)
        temp = temperature if temperature is not None else self.config.temperature(mode)
        yield from self.provider.stream(prompt, max_new_tokens=self.config.max_new_tokens,
                                        temperature=temp, deadline_ts=deadline_ts,
                                        stats=stats, **self._routing(tenant, priority,
                                                                     resumable, request_id))

    def chat_raw(self, prompt: str, max_new_tokens: int, temperature: float,
                 deadline_ts: Optional[float] = None, tenant: Optional[str] = None,
                 priority: Optional[str] = None, request_id: Optional[str] = None) -> str:
        """Direct provider access (the verifier path — shares the weights);
        ``tenant`` / ``priority`` charge the audit to the requesting
        tenant, and ``request_id`` puts its admission on the same flight
        record as the answer's."""
        return self.provider.chat(prompt, max_new_tokens=max_new_tokens,
                                  temperature=temperature, deadline_ts=deadline_ts,
                                  **self._routing(tenant, priority, request_id=request_id))
