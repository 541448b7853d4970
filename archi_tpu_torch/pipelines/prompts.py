"""Prompt templates with required-variable validation.

Copy of ``archi_tpu/pipelines/prompts.py``.

Mirrors the reference's ``ValidatedPromptTemplate`` + ``read_prompt``
(``src/archi/pipelines/classic_pipelines/utils/prompt_validator.py:1-88``):
a format-string template that fails fast when a required input variable is
missing, with file loading and sensible defaults for the built-in pipelines.
"""

from __future__ import annotations

import re
import string
from typing import Any


class ValidatedPromptTemplate:
    def __init__(self, template: str,
                 required_input_variables: list[str] | None = None,
                 name: str = "prompt"):
        self.template = template
        self.name = name
        self.input_variables = self._find_variables(template)
        self.required_input_variables = required_input_variables or []
        missing = set(self.required_input_variables) - set(self.input_variables)
        if missing:
            raise ValueError(
                f"prompt {name!r} is missing required input variables: "
                f"{sorted(missing)}"
            )

    @staticmethod
    def _find_variables(template: str) -> list[str]:
        return [
            fname for _txt, fname, _spec, _conv
            in string.Formatter().parse(template) if fname
        ]

    def format(self, **kwargs: Any) -> str:
        missing = [v for v in self.input_variables if v not in kwargs]
        if missing:
            raise KeyError(
                f"prompt {self.name!r} missing inputs: {missing}"
            )
        safe = {k: ("" if v is None else v) for k, v in kwargs.items()}
        return self.template.format(**safe)

    @classmethod
    def from_file(cls, path: str, **kw) -> "ValidatedPromptTemplate":
        with open(path, encoding="utf-8") as f:
            return cls(f.read(), name=path, **kw)


def read_prompt(path_or_text: str) -> str:
    """File path → contents; literal text passes through (reference
    read_prompt helper)."""
    import os

    if os.path.exists(path_or_text):
        with open(path_or_text, encoding="utf-8") as f:
            return f.read()
    return path_or_text


DEFAULT_PROMPTS = {
    "condense_prompt": (
        "Given the following conversation and a follow-up question, rephrase "
        "the follow-up to be a standalone question that captures all needed "
        "context.\n\nChat history:\n{history}\n\nFollow-up question: "
        "{question}\n\nStandalone question:"
    ),
    "chat_prompt": (
        "You are a helpful research assistant. Use the following retrieved "
        "context to answer the question. If the context is insufficient, say "
        "so.\n\nContext:\n{retriever_output}\n\nQuestion: {question}\n\n"
        "Answer:"
    ),
    "analysis_prompt": (
        "Analyze the following student submission against the rubric.\n\n"
        "Rubric:\n{rubric}\n\nSubmission:\n{submission}\n\nAnalysis:"
    ),
    "summary_prompt": (
        "Summarize this analysis of a student submission concisely.\n\n"
        "Analysis:\n{analysis}\n\nSummary:"
    ),
    "grade_prompt": (
        "Based on the analysis and summary, assign a final grade out of "
        "{max_points} points and justify it briefly.\n\nSummary:\n{summary}"
        "\n\nFinal grade:"
    ),
    "image_prompt": (
        "Transcribe all text and mathematics in the submitted image exactly. "
        "Use LaTeX for equations."
    ),
}


class SafetyChecker:
    """Lightweight input screen (reference ``utils/safety_checker.py:1-55``):
    flags prompt-injection-looking and clearly abusive inputs."""

    PATTERNS = [
        r"ignore (all )?(previous|prior|above) (instructions|prompts)",
        r"disregard (your|the) (system|previous) prompt",
        r"you are now DAN",
        r"\bjailbreak\b",
    ]

    def __init__(self, extra_patterns: list[str] | None = None):
        pats = self.PATTERNS + (extra_patterns or [])
        self._re = [re.compile(p, re.I) for p in pats]

    def check(self, text: str) -> tuple[bool, str]:
        for r in self._re:
            if r.search(text or ""):
                return False, f"input matched safety pattern: {r.pattern}"
        return True, ""
