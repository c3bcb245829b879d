"""AnswerVerifier: LLM self-audit of generated answers — a copy of
``sentio_tpu/ops/verifier.py``.

A temperature-0, bounded-token audit on the generator's own engine that
returns a normalized ``{verdict: pass|warn|fail, citations_ok, notes[<=8],
revised_answer?}``. It never raises: any failure becomes a conservative
``warn`` whose note starts with ``verifier error:``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from sentio_tpu_torch.config import GeneratorConfig
from sentio_tpu_torch.models.document import Document
from sentio_tpu_torch.ops.generator import LLMGenerator
from sentio_tpu_torch.ops.prompts import PromptBuilder
from sentio_tpu_torch.ops.reply_extractor import extract_json_block

VALID_VERDICTS = ("pass", "warn", "fail")


@dataclass
class VerifyResult:
    verdict: str = "warn"
    citations_ok: bool = True
    notes: list[str] = field(default_factory=list)
    revised_answer: Optional[str] = None

    def to_dict(self) -> dict:
        out = {
            "verdict": self.verdict,
            "citations_ok": self.citations_ok,
            "notes": self.notes,
        }
        if self.revised_answer:
            out["revised_answer"] = self.revised_answer
        return out


@dataclass
class AnswerVerifier:
    generator: LLMGenerator
    config: GeneratorConfig = field(default_factory=GeneratorConfig)
    prompts: PromptBuilder = field(default_factory=PromptBuilder)

    def verify(self, query: str, answer: str, documents: Sequence[Document],
               deadline_ts: Optional[float] = None, tenant: Optional[str] = None,
               priority: Optional[str] = None,
               request_id: Optional[str] = None) -> VerifyResult:
        """The audit, charged to the requesting ``tenant`` / ``priority`` on
        the replica tier (a tenant's audits must not ride the shared
        tenant's quota); ``request_id`` puts its engine admission on the
        answer's flight record."""
        try:
            # the audit prompt embeds the generate prompt verbatim as its head
            prompt = self.prompts.build(
                "verify",
                instruction=self.prompts.load("profile"),
                context=self.generator.prepare_context(documents),
                query=query,
                answer=answer,
            )
            reply = self.generator.chat_raw(
                prompt, max_new_tokens=self.config.verifier_max_tokens, temperature=0.0,
                deadline_ts=deadline_ts, tenant=tenant, priority=priority,
                request_id=request_id,
            )
            return self._normalize(reply)
        except Exception as exc:  # noqa: BLE001 — the audit must never fail the answer
            return VerifyResult(verdict="warn", notes=[f"verifier error: {exc}"])

    def _normalize(self, reply: str) -> VerifyResult:
        extracted = extract_json_block(reply)
        if not extracted.ok:
            return VerifyResult(verdict="warn", notes=[f"unparseable audit: {extracted.error}"])
        data = extracted.payload
        verdict = str(data.get("verdict", "warn")).lower()
        if verdict not in VALID_VERDICTS:
            verdict = "warn"
        notes_raw = data.get("notes", [])
        if isinstance(notes_raw, str):
            notes_raw = [notes_raw]
        notes = [str(n) for n in notes_raw][:8]
        revised = data.get("revised_answer")
        return VerifyResult(
            verdict=verdict,
            citations_ok=bool(data.get("citations_ok", True)),
            notes=notes,
            revised_answer=str(revised) if revised else None,
        )
