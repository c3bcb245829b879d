"""Prompt templates: file-loaded, class-cached, with inline fallbacks —
a copy of ``sentio_tpu/ops/prompts.py``.

Templates are the repo-root ``prompts/*.md`` files, read as data; the
substitution is a single-pass literal replace of
``{instruction}/{context}/{query}/{answer}`` (never ``.format``, so braces
in retrieved context stay literal), files are read once per process, and a
missing file falls back to the built-in template.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

# the repo-root prompts/ directory
PROMPTS_DIR = Path(__file__).resolve().parents[2] / "prompts"

_FALLBACK_TEMPLATES = {
    "profile": (
        "You are a retrieval-grounded assistant. Answer strictly from the "
        "provided sources, cite them as [n], and say when the sources are "
        "insufficient."
    ),
    "retrieve": (
        "{instruction}\n\n"
        "Context documents:\n{context}\n\n"
        "Question: {query}\n\n"
        "Answer using only the context above. Cite sources inline as [n]. "
        "If the context does not contain the answer, say so plainly."
    ),
    # the verify prompt EMBEDS the retrieve prompt verbatim as its head —
    # byte-identical through the generate instruction — so the paged
    # engine's radix prefix cache serves the whole generate-prompt span
    # (instruction + context + question) read-only on the verify admission
    # and prefills only the audit tail
    "verify": (
        "{instruction}\n\n"
        "Context documents:\n{context}\n\n"
        "Question: {query}\n\n"
        "Answer using only the context above. Cite sources inline as [n]. "
        "If the context does not contain the answer, say so plainly.\n\n"
        "You are now auditing the answer below for faithfulness to the "
        "context documents above.\n\nAnswer under audit:\n{answer}\n\n"
        'Reply with ONLY a JSON object: {"verdict": "pass"|"warn"|"fail", '
        '"citations_ok": true|false, "notes": ["..."], '
        '"revised_answer": "... (only when verdict is fail)"}'
    ),
    "summarize": "Summarize the following faithfully and concisely:\n\n{context}",
    "fallback_no_retrieval": (
        "I could not search the knowledge base just now. From general "
        "knowledge, with no citations available: {query}"
    ),
    "fallback_no_llm": (
        "The language model is unavailable. The most relevant passages "
        "found were:\n{context}"
    ),
    "fallback_apology": (
        "I'm sorry — I can't answer right now due to an internal error. "
        "Please try again shortly."
    ),
}


class PromptBuilder:
    _cache: dict[str, str] = {}

    def __init__(self, prompts_dir: Optional[str] = None) -> None:
        self.prompts_dir = Path(prompts_dir) if prompts_dir else PROMPTS_DIR

    def static_head(self, name: str, **values) -> str:
        """The template's constant leading text — everything before the
        first request-varying placeholder ({context}/{query}/{answer}) —
        with the given static values substituted. Every ``/chat`` prompt
        built from the template starts with these exact bytes, so
        ``build_pipeline`` warms the engine's radix prefix cache with them."""
        text = self.load(name)
        cut = len(text)
        for dynamic in ("{context}", "{query}", "{answer}"):
            idx = text.find(dynamic)
            if idx != -1:
                cut = min(cut, idx)
        head = text[:cut]
        for key, value in values.items():
            head = head.replace("{" + key + "}", value)
        return head

    def load(self, name: str) -> str:
        cache_key = f"{self.prompts_dir}:{name}"
        cached = self._cache.get(cache_key)
        if cached is not None:
            return cached
        path = self.prompts_dir / f"{name}.md"
        try:
            text = path.read_text().strip()
        except OSError:
            text = _FALLBACK_TEMPLATES.get(name, "{instruction}\n{context}\n{query}")
        self._cache[cache_key] = text
        return text

    def build(
        self,
        name: str,
        instruction: str = "",
        context: str = "",
        query: str = "",
        answer: str = "",
    ) -> str:
        template = self.load(name)
        values = {
            "instruction": instruction, "context": context,
            "query": query, "answer": answer,
        }
        # single-pass substitution: placeholder strings occurring INSIDE a
        # substituted value (an answer quoting "{context}", say) must not be
        # re-expanded, and other braces in retrieved text stay literal
        return re.sub(
            r"\{(instruction|context|query|answer)\}",
            lambda m: values[m.group(1)], template,
        )
