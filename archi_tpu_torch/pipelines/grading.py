"""GradingPipeline: analysis → summary → final grade chained LLM calls.

Copy of ``archi_tpu/pipelines/grading.py``.

Mirrors the reference's ``GradingPipeline``
(``src/archi/pipelines/classic_pipelines/grading.py:18``; ``_init_chains:34``,
``invoke:91``).
"""

from __future__ import annotations

from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.pipelines.base import BasePipeline


class GradingPipeline(BasePipeline):
    DEFAULT_MODEL_KEYS = {
        "analysis_model": "local/echo",
        "summary_model": "local/echo",
        "grade_model": "local/echo",
    }
    PROMPT_KEYS = {
        "analysis_prompt": ["submission"],
        "summary_prompt": ["analysis"],
        "grade_prompt": ["summary"],
    }

    def invoke(self, **kwargs) -> PipelineOutput:
        submission = kwargs.get("submission", "")
        rubric = kwargs.get("rubric", "")
        max_points = kwargs.get("max_points", 100)
        documents = []
        vectorstore = kwargs.get("vectorstore")
        if vectorstore is not None:
            from archi_tpu_torch.retrievers import GradingRetriever

            retriever = GradingRetriever(vectorstore, k=3)
            documents = retriever.invoke(submission[:500])

        analysis = self._call_llm(
            "analysis_model", "analysis_prompt",
            submission=submission, rubric=rubric,
        )
        summary = self._call_llm(
            "summary_model", "summary_prompt", analysis=analysis,
        )
        grade = self._call_llm(
            "grade_model", "grade_prompt",
            summary=summary, max_points=max_points,
        )
        return PipelineOutput(
            answer=grade,
            source_documents=documents,
            metadata={
                "analysis": analysis,
                "summary": summary,
                "max_points": max_points,
                "pipeline_used": self.__class__.__name__,
            },
        )
