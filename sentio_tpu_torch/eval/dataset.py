"""Deterministic synthetic retrieval-QA bundle (NQ-open stand-in) — a
copy of ``sentio_tpu/eval/dataset.py`` (host code: the same seed gives the
same documents and queries in both packages).

Structure mirrors what an open-domain QA eval needs: a corpus where many
documents share vocabulary (same categories, same fact templates) but each
fact is uniquely identified by its entity combination, plus natural-language
questions that PARAPHRASE the fact (different wording, partial entity
mention) and carry a gold document id. Retrieval quality is then a real
signal: recall@10 rewards rankers that separate the right entity's fact
from dozens of lexically-similar distractors, and BM25 / dense / hybrid
legs produce *different* scores, not a saturated 100%.

Everything derives from one integer seed — the bundle is reproducible
across processes and platforms (no file assets, zero egress).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from sentio_tpu_torch.models.document import Document

# entity pools — combinations (subject × component) identify a fact
_SUBJECTS = (
    "aurora", "basilisk", "cascade", "dynamo", "ember", "fjord", "granite",
    "harbor", "iris", "juniper", "krait", "lumen", "meridian", "nimbus",
    "onyx", "pinnacle", "quartz", "ridge", "sable", "tundra", "umbra",
    "vortex", "willow", "xenon", "yonder", "zephyr",
)
_COMPONENTS = (
    "compiler", "scheduler", "allocator", "interconnect", "cache", "runtime",
    "decoder", "indexer", "planner", "profiler",
)
_PEOPLE = (
    "ada chen", "grace okafor", "edsger lindqvist", "katherine bose",
    "alan moreau", "hedy nakamura", "radia vance", "barbara ishii",
    "donald petrov", "frances aguilar",
)
_UNITS = ("gigaflops", "queries per second", "megabytes per joule", "tokens per step")

_FACT_TEMPLATES = (
    "The {subject} {component} was designed by {person} in {year}; "
    "it sustains {value} {unit} under production load.",
    "Project {subject} shipped its {component} in {year}. Lead engineer "
    "{person} measured {value} {unit} in the acceptance benchmark.",
    "In {year}, {person} rebuilt the {component} for the {subject} platform, "
    "reaching {value} {unit} on the standard suite.",
)

_QUESTION_TEMPLATES = (
    "who designed the {subject} {component}?",
    "what year did the {subject} {component} ship?",
    "how fast is the {component} of {subject}?",
    "which engineer worked on {subject}'s {component}?",
    "what performance does the {subject} {component} reach?",
)

_NOISE_TEMPLATES = (
    "Meeting notes {i}: the weekly sync covered roadmap priorities, hiring "
    "updates, and the quarterly review schedule for the infrastructure team.",
    "Changelog entry {i}: fixed a flaky integration test, bumped the linter "
    "version, and refreshed the contributor documentation pages.",
    "Incident report {i}: a configuration rollout briefly elevated error "
    "rates; the on-call engineer rolled back and filed a postmortem.",
)


@dataclass
class EvalBundle:
    documents: list  # list[Document]
    queries: list[tuple[str, str]]  # (question, gold document id)
    seed: int

    @property
    def n_facts(self) -> int:
        return sum(1 for d in self.documents if d.id.startswith("fact-"))


def build_bundle(
    n_docs: int = 1024, n_queries: int = 64, seed: int = 0
) -> EvalBundle:
    """Corpus of ``n_docs`` documents (≈70% entity facts, 30% noise) and
    ``n_queries`` paraphrased questions with gold ids."""
    rng = np.random.default_rng(seed)
    combos = [(s, c) for s in _SUBJECTS for c in _COMPONENTS]
    rng.shuffle(combos)
    n_facts = min(max(int(n_docs * 0.7), 1), len(combos))

    documents: list[Document] = []
    for i in range(n_facts):
        subject, component = combos[i]
        person = _PEOPLE[int(rng.integers(len(_PEOPLE)))]
        year = 1990 + int(rng.integers(35))
        value = int(rng.integers(10, 9000))
        unit = _UNITS[int(rng.integers(len(_UNITS)))]
        template = _FACT_TEMPLATES[int(rng.integers(len(_FACT_TEMPLATES)))]
        documents.append(
            Document(
                text=template.format(
                    subject=subject, component=component, person=person,
                    year=year, value=value, unit=unit,
                ),
                id=f"fact-{subject}-{component}",
                metadata={"source": f"{subject}/{component}.md"},
            )
        )
    for i in range(n_docs - n_facts):
        template = _NOISE_TEMPLATES[i % len(_NOISE_TEMPLATES)]
        documents.append(
            Document(
                text=template.format(i=i),
                id=f"noise-{i}",
                metadata={"source": f"notes/{i}.md"},
            )
        )

    queries: list[tuple[str, str]] = []
    for i in range(n_queries):
        subject, component = combos[int(rng.integers(n_facts))]
        template = _QUESTION_TEMPLATES[int(rng.integers(len(_QUESTION_TEMPLATES)))]
        queries.append(
            (template.format(subject=subject, component=component),
             f"fact-{subject}-{component}")
        )
    return EvalBundle(documents=documents, queries=queries, seed=seed)
