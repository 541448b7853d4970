"""Archi — the orchestration facade.

Copy of ``archi_tpu/orchestrator/archi.py``.

Mirrors the reference's ``archi`` class (``src/archi/archi.py:9``):
instantiate a pipeline (or agent) by registry name, inject a vectorstore
handle into every call (``_prepare_call_kwargs:61``), validate that
pipelines return ``PipelineOutput``, and expose ``invoke``/``stream``/
``astream`` (``archi.py:83,93,103``).
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Iterator, Optional

from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.orchestrator.vectorstore_connector import VectorstoreConnector
from archi_tpu_torch.providers.registry import configure_providers


def pipeline_registry() -> dict[str, type]:
    """Name → class (reference ``src/archi/pipelines/__init__.py:3-17``)."""
    from archi_tpu_torch.pipelines.agents.base_react import BaseReActAgent
    from archi_tpu_torch.pipelines.agents.comp_ops import CMSCompOpsAgent
    from archi_tpu_torch.pipelines.base import BasePipeline
    from archi_tpu_torch.pipelines.grading import GradingPipeline
    from archi_tpu_torch.pipelines.image_processing import ImageProcessingPipeline
    from archi_tpu_torch.pipelines.qa import QAPipeline

    return {
        "BasePipeline": BasePipeline,
        "QAPipeline": QAPipeline,
        "GradingPipeline": GradingPipeline,
        "ImageProcessingPipeline": ImageProcessingPipeline,
        "BaseReActAgent": BaseReActAgent,
        "CMSCompOpsAgent": CMSCompOpsAgent,
    }


class Archi:
    def __init__(
        self,
        pipeline: str = "QAPipeline",
        *,
        config: Optional[dict[str, Any]] = None,
        vectorstore=None,
        **pipeline_kwargs,
    ):
        self.config = config or {}
        if self.config.get("providers"):
            configure_providers(self.config["providers"])
        registry = pipeline_registry()
        if pipeline not in registry:
            raise ValueError(
                f"unknown pipeline {pipeline!r}; have {sorted(registry)}"
            )
        self.pipeline_name = pipeline
        self.pipeline = registry[pipeline](self.config, **pipeline_kwargs)
        self.vs_connector = VectorstoreConnector(
            self.config, vectorstore=vectorstore
        )

    # ------------------------------------------------------------- internals
    def _prepare_call_kwargs(self, **kwargs) -> dict[str, Any]:
        """Fresh vectorstore handle per call (reference archi.py:61-65)."""
        kwargs.setdefault("vectorstore", self.vs_connector.get_vectorstore())
        return kwargs

    @staticmethod
    def _validate(output: Any) -> PipelineOutput:
        if not isinstance(output, PipelineOutput):
            raise TypeError(
                f"pipeline must return PipelineOutput, got {type(output)}"
            )
        return output

    # ------------------------------------------------------------------ api
    def invoke(self, **kwargs) -> PipelineOutput:
        kwargs = self._prepare_call_kwargs(**kwargs)
        return self._validate(self.pipeline.invoke(**kwargs))

    def stream(self, **kwargs) -> Iterator[PipelineOutput]:
        kwargs = self._prepare_call_kwargs(**kwargs)
        for out in self.pipeline.stream(**kwargs):
            yield self._validate(out)

    async def astream(self, **kwargs) -> AsyncIterator[PipelineOutput]:
        kwargs = self._prepare_call_kwargs(**kwargs)
        astream = getattr(self.pipeline, "astream", None)
        if astream is not None:
            async for out in astream(**kwargs):
                yield self._validate(out)
            return
        loop = asyncio.get_event_loop()
        it = self.pipeline.stream(**kwargs)
        while True:
            out = await loop.run_in_executor(None, lambda: next(it, None))
            if out is None:
                break
            yield self._validate(out)

    def __call__(self, **kwargs) -> PipelineOutput:
        return self.invoke(**kwargs)
