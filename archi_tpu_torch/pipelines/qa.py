"""QAPipeline: condense history → hybrid retrieval → stuffed answer.

Copy of ``archi_tpu/pipelines/qa.py``.

Mirrors the reference's ``QAPipeline``
(``src/archi/pipelines/classic_pipelines/qa.py:20``): chains at ``:31-51``,
``invoke:81-118``, retriever wiring ``update_retriever:68``.
"""

from __future__ import annotations

from typing import Any

from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.pipelines.base import BasePipeline
from archi_tpu_torch.utils.messages import tuplize_history


class QAPipeline(BasePipeline):
    DEFAULT_MODEL_KEYS = {
        "condense_model": "local/echo",
        "chat_model": "local/echo",
    }
    PROMPT_KEYS = {
        "condense_prompt": ["history"],
        "chat_prompt": ["question"],
    }

    def _prepare_inputs(self, history: Any) -> dict[str, Any]:
        full_history = tuplize_history(history)
        question = full_history[-1][1] if full_history else ""
        return {
            "question": question,
            "history": full_history[:-1],
            "full_history": full_history,
        }

    def invoke(self, **kwargs) -> PipelineOutput:
        vectorstore = kwargs.get("vectorstore")
        if vectorstore is not None:
            self.update_retriever(vectorstore, kwargs.get("enabled_ids"))

        inputs = self._prepare_inputs(kwargs.get("history"))

        if inputs["history"]:
            condensed = self._call_llm(
                "condense_model", "condense_prompt",
                history=inputs["history"], question=inputs["question"],
            )
        else:  # nothing to condense
            condensed = inputs["question"]

        documents: list = []
        scores: list = []
        if self.retriever is not None:
            retrieved = self.retriever.invoke(condensed)
            if retrieved:
                documents = [d for d, _s in retrieved]
                scores = [s for _d, s in retrieved]

        answer = self._call_llm(
            "chat_model", "chat_prompt",
            question=inputs["question"],
            retriever_output=documents if documents else "",
        )

        chat_model = self.llms.get("chat_model")
        return PipelineOutput(
            answer=answer,
            source_documents=documents,
            messages=[],
            metadata={
                "retriever_scores": scores,
                "condensed_output": condensed,
                "question": inputs["question"],
                "model_used": getattr(chat_model, "model_name", "unknown"),
                "pipeline_used": self.__class__.__name__,
            },
        )

    def stream(self, **kwargs):
        """True token streaming: condense + retrieve, then stream the chat
        model's deltas (reference token-delta SSE events,
        ``chat_app/app.py:1385,3554``)."""
        from archi_tpu_torch.utils.messages import user

        vectorstore = kwargs.get("vectorstore")
        if vectorstore is not None:
            self.update_retriever(vectorstore, kwargs.get("enabled_ids"))
        inputs = self._prepare_inputs(kwargs.get("history"))
        if inputs["history"]:
            condensed = self._call_llm(
                "condense_model", "condense_prompt",
                history=inputs["history"], question=inputs["question"],
            )
        else:
            condensed = inputs["question"]
        documents, scores = [], []
        if self.retriever is not None:
            retrieved = self.retriever.invoke(condensed)
            if retrieved:
                documents = [d for d, _s in retrieved]
                scores = [s for _d, s in retrieved]
        yield PipelineOutput(
            answer="", final=False,
            metadata={"event": {
                "type": "retrieval", "condensed": condensed,
                "n_documents": len(documents)}},
        )

        pruned = self.token_limiter.prune_inputs_to_token_limit({
            "question": inputs["question"],
            "retriever_output": documents if documents else "",
        })
        prompt = self.prompts["chat_prompt"].format(
            question=pruned["question"],
            retriever_output=self._render_value(pruned["retriever_output"]),
        )
        parts: list[str] = []
        for chunk in self.llms["chat_model"].stream([user(prompt)]):
            if chunk.content:
                parts.append(chunk.content)
                if chunk.metadata.get("delta"):
                    yield PipelineOutput(
                        answer="", final=False,
                        metadata={"event": {"type": "token",
                                            "delta": chunk.content}},
                    )
        answer = "".join(parts)
        chat_model = self.llms.get("chat_model")
        yield PipelineOutput(
            answer=answer,
            source_documents=documents,
            metadata={
                "retriever_scores": scores,
                "condensed_output": condensed,
                "question": inputs["question"],
                "model_used": getattr(chat_model, "model_name", "unknown"),
                "pipeline_used": self.__class__.__name__,
            },
        )
