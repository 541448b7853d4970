"""BaseReActAgent: the tool-calling agent loop.

Copy of ``archi_tpu/pipelines/agents/base_react.py``.

Mirrors the reference's ``BaseReActAgent``
(``src/archi/pipelines/agents/base_react.py:28``, 1,708 LoC) without
LangGraph: a native tool-calling loop over our provider ``ChatModel``
interface.  Feature parity:

- tool set assembly + refresh (``refresh_agent:994``, ``_create_agent:1041``),
- sync ``invoke:252`` and streaming ``stream:282`` with structured step
  events (agent_step / tool_start / tool_result / final),
- ``astream:562`` via a thread executor,
- ``<think>...</think>`` parsing out of model content,
- token-usage aggregation across steps,
- recursion limit with graceful final-answer recovery
  (``DEFAULT_RECURSION_LIMIT = 50 :33``),
- context-overflow handling: compress old history into a summary and retry
  (``_compress_history:1309``, ``_handle_context_overflow:1449``),
- per-run ``RunMemory`` feeding ``PipelineOutput.metadata``.
"""

from __future__ import annotations

import logging
import re
import uuid
from typing import AsyncIterator, Iterator, Optional

from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.pipelines.agents.run_memory import RunMemory
from archi_tpu_torch.pipelines.agents.tools.base import Tool, ToolPermissionError
from archi_tpu_torch.pipelines.agents.tools.retriever import create_retriever_tool
from archi_tpu_torch.pipelines.base import BasePipeline
from archi_tpu_torch.utils.messages import (
    Message, assistant, system, tool_result, tuplize_history, user,
)

logger = logging.getLogger(__name__)

DEFAULT_RECURSION_LIMIT = 50
_THINK_RE = re.compile(r"<think>(.*?)</think>", re.S)

DEFAULT_AGENT_PROMPT = (
    "You are a helpful research assistant with access to tools. Use the "
    "tools to find accurate information before answering. Cite the sources "
    "you used. If the tools return nothing useful, say what you tried."
)


def split_think(content: str) -> tuple[str, str]:
    """→ (visible_text, thinking) — reference <think> parsing."""
    thinking = "\n".join(m.strip() for m in _THINK_RE.findall(content or ""))
    visible = _THINK_RE.sub("", content or "").strip()
    return visible, thinking


class ContextOverflowError(RuntimeError):
    pass


def _looks_like_overflow(err: Exception) -> bool:
    s = str(err).lower()
    return any(t in s for t in (
        "context length", "context_length", "maximum context",
        "too many tokens", "prompt is too long", "request too large",
    ))


class BaseReActAgent(BasePipeline):
    DEFAULT_MODEL_KEYS = {"agent_model": "local/echo"}
    PROMPT_KEYS: dict[str, list] = {}

    def __init__(self, config: Optional[dict] = None, *,
                 tools: Optional[list[Tool]] = None,
                 system_prompt: Optional[str] = None,
                 recursion_limit: int = DEFAULT_RECURSION_LIMIT,
                 session_permissions: Optional[set[str]] = None,
                 **kw):
        super().__init__(config, **kw)
        agent_cfg = self.pipeline_config
        self.system_prompt = (
            system_prompt or agent_cfg.get("system_prompt")
            or DEFAULT_AGENT_PROMPT
        )
        self.recursion_limit = agent_cfg.get("recursion_limit",
                                             recursion_limit)
        self.session_permissions = session_permissions
        self._extra_tools = tools or []
        self._enabled_ids = None
        self.run_memory = RunMemory()
        self.tools: list[Tool] = []
        self.refresh_agent()

    # ------------------------------------------------------------- assembly
    def _tool_definitions(self, vectorstore=None) -> list[Tool]:
        """Override point: subclasses add their tool registry (reference
        CMSCompOpsAgent._tool_definitions:85-150)."""
        tools = list(self._extra_tools)
        if vectorstore is not None:
            self.update_retriever(vectorstore, self._enabled_ids)
            tools.append(create_retriever_tool(
                self.retriever, run_memory=self.run_memory,
            ))
        return tools

    def refresh_agent(self, vectorstore=None, enabled_ids=None) -> None:
        """Rebuild the tool set / system prompt (reference
        refresh_agent:994 — called per request with a fresh vectorstore)."""
        self.run_memory = RunMemory()
        self._enabled_ids = enabled_ids
        self.tools = self._tool_definitions(vectorstore)
        self._tools_by_name = {t.name: t for t in self.tools}

    # ------------------------------------------------------------ internals
    def _build_messages(self, history) -> list[Message]:
        msgs = [system(self.system_prompt)]
        for role, content in tuplize_history(history):
            role_l = role.lower()
            if role_l in ("user", "human"):
                msgs.append(user(content))
            elif role_l in ("assistant", "ai", "archi"):
                msgs.append(assistant(content))
            elif role_l == "system":
                msgs.append(system(content))
            else:
                msgs.append(user(content))
        return msgs

    def _compress_history(self, messages: list[Message]) -> list[Message]:
        """Summarize all but the newest turns into one system note
        (reference _compress_history:1309-1367)."""
        if len(messages) <= 4:
            return messages
        head, tail = messages[1:-3], messages[-3:]
        transcript = "\n".join(f"{m.role}: {m.content[:500]}" for m in head)
        try:
            summary = self.llms["agent_model"].invoke([
                user("Summarize this conversation so far in under 200 "
                     f"words, keeping all facts and decisions:\n{transcript}")
            ]).content
        except Exception:
            summary = transcript[:1000]
        return [messages[0],
                system(f"[Earlier conversation, summarized]\n{summary}"),
                *tail]

    def _handle_context_overflow(self, messages: list[Message],
                                 attempt: int) -> list[Message]:
        """Reference _handle_context_overflow:1449: compress, then truncate
        tool results, then give up."""
        if attempt == 0:
            return self._compress_history(messages)
        if attempt == 1:
            return [
                Message(m.role, m.content[:1000], tool_calls=m.tool_calls,
                        tool_call_id=m.tool_call_id, name=m.name)
                for m in messages
            ]
        raise ContextOverflowError("context overflow after compression")

    def _model_step(self, messages: list[Message]) -> Message:
        schemas = [t.schema() for t in self.tools] or None
        for attempt in range(3):
            try:
                reply = self.llms["agent_model"].invoke(
                    messages, tools=schemas
                )
                self.run_memory.add_usage(reply.usage)
                return reply
            except Exception as e:
                if _looks_like_overflow(e):
                    messages[:] = self._handle_context_overflow(
                        messages, attempt
                    )
                    continue
                raise
        raise ContextOverflowError("model call failed after compression")

    def _run_tool(self, call) -> str:
        tool = self._tools_by_name.get(call.name)
        if tool is None:
            return f"Unknown tool: {call.name}"
        try:
            return tool.run(call.args, self.session_permissions)
        except ToolPermissionError as e:
            return f"Permission denied: {e}"

    # ------------------------------------------------------------------ api
    def invoke(self, **kwargs) -> PipelineOutput:
        final = None
        for out in self.stream(**kwargs):
            if out.final:
                final = out
        assert final is not None
        return final

    def stream(self, **kwargs) -> Iterator[PipelineOutput]:
        """Structured step events then the final output (reference
        stream:282 emits agent_step/tool_start/tool_result events)."""
        vectorstore = kwargs.get("vectorstore")
        self.refresh_agent(vectorstore, kwargs.get("enabled_ids"))
        messages = self._build_messages(kwargs.get("history"))
        transcript: list[Message] = []

        def event(kind: str, **payload) -> PipelineOutput:
            return PipelineOutput(
                answer="", final=False,
                metadata={"event": {"type": kind, **payload}},
            )

        stream_tokens = kwargs.get("stream_tokens", True)
        answer = ""
        hit_limit = False
        for step in range(self.recursion_limit):
            self.run_memory.steps = step + 1
            if stream_tokens:
                # true token streaming, including through tool-call turns
                # (reference streams model deltas over SSE, app.py:1385,3554)
                schemas = [t.schema() for t in self.tools] or None
                parts: list[str] = []
                calls: list = []
                usage: dict = {}
                reply = None
                try:
                    for chunk in self.llms["agent_model"].stream(
                            messages + transcript, tools=schemas):
                        if chunk.metadata.get("delta"):
                            parts.append(chunk.content)
                            yield event("token", delta=chunk.content,
                                        step=step)
                        else:
                            if chunk.content:
                                parts.append(chunk.content)
                            if chunk.tool_calls:
                                calls.extend(chunk.tool_calls)
                            if chunk.usage:
                                usage = chunk.usage
                except Exception:
                    if parts or calls:
                        raise  # mid-stream failure is not retryable
                    reply = self._model_step(messages + transcript)
                if reply is None:
                    reply = Message("assistant", "".join(parts),
                                    tool_calls=calls, usage=usage)
                    self.run_memory.add_usage(usage)
            else:
                reply = self._model_step(messages + transcript)
            visible, thinking = split_think(reply.content)
            if thinking:
                yield event("thinking", content=thinking, step=step)
            if not reply.tool_calls:
                answer = visible
                transcript.append(reply)
                break
            transcript.append(reply)
            yield event("agent_step", step=step, content=visible,
                        tool_calls=[{"name": c.name, "args": c.args,
                                     "id": c.id} for c in reply.tool_calls])
            for call in reply.tool_calls:
                if not call.id:
                    call.id = str(uuid.uuid4())
                yield event("tool_start", name=call.name, args=call.args,
                            id=call.id)
            # run the turn's tool calls concurrently (providers batch
            # independent calls; serializing them wastes wall-clock)
            if len(reply.tool_calls) > 1:
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(
                        max_workers=min(8, len(reply.tool_calls))) as pool:
                    results = list(pool.map(self._run_tool,
                                            reply.tool_calls))
            else:
                results = [self._run_tool(c) for c in reply.tool_calls]
            for call, result in zip(reply.tool_calls, results):
                self.run_memory.record_tool_call(
                    call.id, call.name, call.args, result[:2000]
                )
                transcript.append(tool_result(call.id, result,
                                              name=call.name))
                yield event("tool_result", name=call.name, id=call.id,
                            result=result[:2000])
        else:
            # recursion limit: one last call without tools for a best-effort
            # answer (reference recursion-limit recovery)
            hit_limit = True
            try:
                reply = self.llms["agent_model"].invoke(
                    messages + transcript + [
                        user("Tool budget exhausted. Give your best final "
                             "answer from what you have gathered.")
                    ]
                )
                answer, _ = split_think(reply.content)
                transcript.append(reply)
            except Exception as e:
                answer = f"(stopped at recursion limit: {e})"

        docs = self.run_memory.unique_documents()
        yield PipelineOutput(
            answer=answer,
            source_documents=[d for d, _s in docs],
            messages=transcript,
            metadata={
                "retriever_scores": [s for _d, s in docs],
                "tool_inputs_by_id": self.run_memory.tool_inputs_by_id(),
                "tool_calls": self.run_memory.tool_calls,
                "usage": dict(self.run_memory.usage),
                "steps": self.run_memory.steps,
                "hit_recursion_limit": hit_limit,
                "notes": self.run_memory.notes,
                "model_used": getattr(self.llms["agent_model"],
                                      "model_name", "unknown"),
                "pipeline_used": self.__class__.__name__,
            },
        )

    async def astream(self, **kwargs) -> AsyncIterator[PipelineOutput]:
        import asyncio

        loop = asyncio.get_event_loop()
        it = self.stream(**kwargs)
        while True:
            out = await loop.run_in_executor(None, lambda: next(it, None))
            if out is None:
                break
            yield out
