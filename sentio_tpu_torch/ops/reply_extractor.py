"""Robust JSON-from-LLM extraction, copied from
``sentio_tpu/ops/reply_extractor.py``.

Models wrap JSON in prose and markdown fences; extraction tries, in order,
(1) fenced ```json blocks, (2) the largest balanced ``{...}`` span, (3) a
trailing-comma/single-quote-tolerant relaxed parse. Never raises — a failed
extraction returns a ``None`` payload with the error recorded.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from typing import Any, Optional

_FENCE_RE = re.compile(r"```(?:json)?\s*(\{.*?\})\s*```", re.DOTALL)


@dataclass
class JsonExtractResult:
    payload: Optional[dict[str, Any]]
    raw_span: str = ""
    error: str = ""

    @property
    def ok(self) -> bool:
        return self.payload is not None


def _balanced_spans(text: str) -> list[str]:
    """All top-level balanced {...} spans, largest first, string-aware."""
    spans = []
    depth = 0
    start = -1
    in_str = False
    escape = False
    for i, ch in enumerate(text):
        if escape:
            escape = False
            continue
        if ch == "\\" and in_str:
            escape = True
            continue
        if ch == '"':
            in_str = not in_str
            continue
        if in_str:
            continue
        if ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}" and depth > 0:
            depth -= 1
            if depth == 0 and start >= 0:
                spans.append(text[start : i + 1])
    return sorted(spans, key=len, reverse=True)


def _relaxed_parse(span: str) -> Optional[dict]:
    """Tolerate trailing commas and single-quoted (python-repr-style) JSON."""
    fixed = re.sub(r",\s*([}\]])", r"\1", span)
    try:
        return json.loads(fixed)
    except json.JSONDecodeError:
        pass
    # single-quoted dicts are python literals: literal_eval handles quote
    # nesting correctly where naive regex swapping cannot
    import ast

    for candidate in (fixed, _bare_words_to_python(fixed)):
        try:
            obj = ast.literal_eval(candidate)
        except (ValueError, SyntaxError, MemoryError, RecursionError):
            continue
        if isinstance(obj, dict):
            return obj
    return None


def _bare_words_to_python(span: str) -> str:
    """Rewrite bare true/false/null to True/False/None OUTSIDE string
    literals only — 'the claim is true' inside a value must stay untouched."""
    out: list[str] = []
    i = 0
    quote: Optional[str] = None
    replacements = {"true": "True", "false": "False", "null": "None"}
    while i < len(span):
        ch = span[i]
        if quote is not None:
            out.append(ch)
            if ch == "\\" and i + 1 < len(span):
                out.append(span[i + 1])
                i += 2
                continue
            if ch == quote:
                quote = None
            i += 1
            continue
        if ch in ("'", '"'):
            quote = ch
            out.append(ch)
            i += 1
            continue
        matched = False
        for word, repl in replacements.items():
            end = i + len(word)
            if (
                span[i:end] == word
                and (i == 0 or not (span[i - 1].isalnum() or span[i - 1] == "_"))
                and (end >= len(span) or not (span[end].isalnum() or span[end] == "_"))
            ):
                out.append(repl)
                i = end
                matched = True
                break
        if not matched:
            out.append(ch)
            i += 1
    return "".join(out)


def extract_json_block(text: str) -> JsonExtractResult:
    if not text or not text.strip():
        return JsonExtractResult(None, error="empty reply")

    candidates: list[str] = []
    for m in _FENCE_RE.finditer(text):
        candidates.append(m.group(1))
    candidates.extend(_balanced_spans(text))

    last_err = "no JSON object found"
    for span in candidates:
        try:
            payload = json.loads(span)
        except json.JSONDecodeError as exc:
            payload = _relaxed_parse(span)
            if payload is None:
                last_err = f"JSON parse failed: {exc}"
                continue
        if isinstance(payload, dict):
            return JsonExtractResult(payload, raw_span=span)
        last_err = "top-level JSON was not an object"
    return JsonExtractResult(None, error=last_err)
