"""BasePipeline: config-driven models + validated prompts.

Mirrors the reference's ``BasePipeline``
(``src/archi/pipelines/classic_pipelines/base.py:16``; ``_init_llms:52``,
``_init_prompts:97``, ``_default_model_keys:137``): each pipeline declares
model keys that resolve 'provider/model' refs through the provider registry,
and prompt keys that load from config (file path or literal) with
required-variable validation, falling back to built-in defaults.

Counterpart of ``archi_tpu/pipelines/base.py``; the code is the
reference's but for one condition.  The JAX package builds the MaxSim
rerank step only for an embedder with ``params`` (its ``JaxEmbedder``);
here it is built for the port's local embedder, the one with a ``model``
that ``MaxSimReranker`` encodes tokens with.  A remote store (no
``_embedding_function``) and an embedder without an encoder (``hash``)
still skip the rerank, as in the JAX package.
"""

from __future__ import annotations

import logging
from abc import ABC, abstractmethod
from typing import Any

from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.pipelines.prompts import (
    DEFAULT_PROMPTS, ValidatedPromptTemplate, read_prompt,
)
from archi_tpu_torch.pipelines.token_limiter import TokenLimiter
from archi_tpu_torch.providers.registry import get_model

logger = logging.getLogger(__name__)


class BasePipeline(ABC):
    #: model-key → default 'provider/model' ref; overridden per pipeline
    DEFAULT_MODEL_KEYS: dict[str, str] = {"chat_model": "local/echo"}
    #: prompt-key → required input variables
    PROMPT_KEYS: dict[str, list[str]] = {}

    def __init__(self, config: dict[str, Any] | None = None, **kwargs):
        self.config = config or {}
        self.pipeline_config = self._pipeline_section()
        self.dm_config = self.config.get("data_manager", {})
        self.llms = self._init_llms()
        self.prompts = self._init_prompts()
        self.token_limiter = TokenLimiter(
            max_tokens=self.pipeline_config.get("max_tokens", 7000)
        )
        self.retriever = None

    def _pipeline_section(self) -> dict:
        pipelines = self.config.get("pipelines", {})
        return pipelines.get(self.__class__.__name__, {}) or {}

    def _init_llms(self) -> dict[str, Any]:
        llms = {}
        model_cfg = self.pipeline_config.get("models", {})
        for key, default_ref in self.DEFAULT_MODEL_KEYS.items():
            ref = model_cfg.get(key, default_ref)
            kwargs = self.pipeline_config.get("model_kwargs", {}).get(key, {})
            llms[key] = get_model(ref, **kwargs)
            logger.debug("pipeline %s model %s -> %s",
                         self.__class__.__name__, key, ref)
        return llms

    def _init_prompts(self) -> dict[str, ValidatedPromptTemplate]:
        prompts = {}
        prompt_cfg = self.pipeline_config.get("prompts", {})
        for key, required in self.PROMPT_KEYS.items():
            raw = prompt_cfg.get(key)
            text = read_prompt(raw) if raw else DEFAULT_PROMPTS[key]
            prompts[key] = ValidatedPromptTemplate(
                text, required_input_variables=required, name=key
            )
        return prompts

    def _call_llm(self, model_key: str, prompt_key: str, **inputs) -> str:
        """Render prompt (with token pruning) → invoke model → text.
        The ChainWrapper analog (reference ``utils/chain_wrappers.py:14``)."""
        from archi_tpu_torch.utils.messages import user

        inputs = self.token_limiter.prune_inputs_to_token_limit(inputs)
        rendered = {k: self._render_value(v) for k, v in inputs.items()}
        prompt = self.prompts[prompt_key].format(**rendered)
        reply = self.llms[model_key].invoke([user(prompt)])
        return reply.content

    @staticmethod
    def _render_value(v: Any) -> Any:
        from archi_tpu_torch.utils.documents import Document

        if isinstance(v, list) and v and isinstance(v[0], Document):
            return "\n\n".join(d.page_content for d in v)
        if isinstance(v, list) and v and isinstance(v[0], (tuple, list)):
            return "\n".join(f"{r}: {c}" for r, c in v)
        return v

    def update_retriever(self, vectorstore, enabled_ids=None) -> None:
        """Default: hybrid retriever from data_manager config (reference
        qa.py:68-80); enabled_ids carries the per-conversation document
        selection (3-tier analog)."""
        from archi_tpu_torch.retrievers import HybridRetriever

        hybrid_cfg = (self.dm_config.get("retrievers", {})
                      .get("hybrid_retriever", {}))
        k = hybrid_cfg.get("num_documents_to_retrieve", 5)
        rerank_cfg = hybrid_cfg.get("rerank") or {}
        base_k = k
        if rerank_cfg.get("enabled"):
            base_k = max(k, int(rerank_cfg.get("overfetch", 4 * k)))
        self.retriever = HybridRetriever(
            vectorstore,
            k=base_k,
            bm25_weight=hybrid_cfg.get("bm25_weight", 0.6),
            semantic_weight=hybrid_cfg.get("semantic_weight", 0.4),
            enabled_ids=enabled_ids,
        )
        if rerank_cfg.get("enabled"):
            # MaxSim late-interaction reranking over the over-fetched pool
            # (engine/reranker.py — a capability beyond the reference stack);
            # needs the local embedder (token-level output), so remote
            # vectorstores skip it gracefully.
            embedder = getattr(vectorstore, "_embedding_function", None)
            if embedder is not None and hasattr(embedder, "model"):
                from archi_tpu_torch.engine.reranker import (
                    MaxSimReranker, RerankingRetriever,
                )

                self.retriever = RerankingRetriever(
                    self.retriever, MaxSimReranker(embedder), k=k)

    @abstractmethod
    def invoke(self, **kwargs) -> PipelineOutput:
        ...

    def stream(self, **kwargs):
        """Default streaming: yield the final output once."""
        yield self.invoke(**kwargs)
