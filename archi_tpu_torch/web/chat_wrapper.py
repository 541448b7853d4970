"""ChatWrapper: the locked chat executor behind the chat service.

Copy of ``archi_tpu/web/chat_wrapper.py``.

Mirrors the reference's ``ChatWrapper`` (``src/interfaces/chat_app/app.py:218``):
- a lock serializes chat execution (``app.py:224``),
- per-call: ownership check + history fetch → run the Archi pipeline →
  persist messages, timing decomposition, tool calls → format sources with a
  score threshold (``__call__:1527``, ``_finalize_result:1460``),
- streaming (``stream:1586``) emits structured SSE events and writes
  ``agent_traces`` rows live, honoring cancellation
  (``app.py:855-1040,1012``),
- optional per-request provider/model override via BYOK
  (``app.py:1680-1686``),
- A/B comparisons run two models on the same question (``app.py:672-853``).
"""

from __future__ import annotations

import threading
from typing import Iterator, Optional

from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.utils.conversation_service import ConversationService
from archi_tpu_torch.utils.timing import TimingRecorder
from archi_tpu_torch.utils.trace_service import TraceService


class ChatAccessError(PermissionError):
    pass


class ChatWrapper:
    def __init__(
        self,
        archi: Archi,
        conversations: ConversationService,
        traces: TraceService,
        *,
        source_score_threshold: float = 0.0,
        byok_resolver=None,
        catalog=None,
        agent_resolver=None,
    ):
        self._default_archi = archi
        self.conversations = conversations
        self.traces = traces
        self.source_score_threshold = source_score_threshold
        self.byok_resolver = byok_resolver
        self.catalog = catalog  # for per-conversation doc selection
        # callable () -> Optional[Archi]: the runtime-selected agent
        # (dynamic-config active_agent → AgentSpec → BaseReActAgent); None
        # keeps the default pipeline (reference agent selection,
        # app.py:2218 set_active_agent)
        self.agent_resolver = agent_resolver
        self.lock = threading.Lock()

    @property
    def archi(self):
        if self.agent_resolver is not None:
            try:
                selected = self.agent_resolver()
            except Exception:
                selected = None
            if selected is not None:
                return selected
        return self._default_archi

    @archi.setter
    def archi(self, value):
        self._default_archi = value

    # ------------------------------------------------------------- internals
    def _prepare(self, conversation_id: Optional[int], user_id: Optional[int],
                 message: str, timing: TimingRecorder):
        """Ownership check + history fetch (reference
        _prepare_chat_context:1325)."""
        if conversation_id is None:
            conversation_id = self.conversations.create_conversation(
                user_id, title=message[:60]
            )
        else:
            conv = self.conversations.get_conversation(conversation_id)
            if conv is None:
                raise ChatAccessError("conversation not found")
            if user_id is not None and conv.get("user_id") not in (None, user_id):
                raise ChatAccessError("conversation belongs to another user")
        history = self.conversations.get_history(conversation_id)
        timing.stamp("query_convo_history")
        history = history + [("User", message)]
        # per-conversation document selection (3-tier analog; None = all)
        enabled = None
        if self.catalog is not None:
            enabled = self.catalog.enabled_hashes(str(conversation_id))
        return conversation_id, history, enabled

    def _format_sources(self, output: PipelineOutput) -> list[dict]:
        """Sources above threshold, deduped by resource (reference source
        formatting with score threshold)."""
        scores = (output.metadata or {}).get("retriever_scores") or []
        out, seen = [], set()
        for i, doc in enumerate(output.source_documents):
            score = scores[i] if i < len(scores) else 0.0
            if score < self.source_score_threshold:
                continue
            md = doc.metadata or {}
            key = md.get("resource_hash") or md.get("display_name") or i
            if key in seen:
                continue
            seen.add(key)
            out.append({
                "display_name": md.get("display_name"),
                "url": md.get("url"),
                "source_type": md.get("source_type"),
                "resource_hash": md.get("resource_hash"),
                "score": round(float(score), 4),
            })
        return out

    def _resolve_model_override(self, user_email: Optional[str],
                                model_ref: Optional[str]):
        """Per-request model override, preferring the user's BYOK key
        (reference app.py:1680-1686).  Returns the original llms dict so the
        caller can restore it — a leaked override would run later users'
        requests on this user's (possibly BYOK-billed) model."""
        pipeline = self.archi.pipeline
        saved = dict(pipeline.llms)
        if not model_ref:
            return saved
        model = None
        if self.byok_resolver is not None and user_email:
            model = self.byok_resolver.get_model(user_email, model_ref)
        if model is None:
            from archi_tpu_torch.providers.registry import get_model

            model = get_model(model_ref)
        for key in pipeline.llms:
            if key in ("chat_model", "agent_model"):
                pipeline.llms[key] = model
        return saved

    def _finalize(self, conversation_id: int, message: str,
                  output: PipelineOutput, timing: TimingRecorder) -> dict:
        """Persist user+assistant messages, timing, tool calls (reference
        _finalize_result:1460, insert_tool_calls_from_output:1219)."""
        self.conversations.add_message(conversation_id, "User", message)
        msg_id = self.conversations.add_message(
            conversation_id, "archi", output.answer,
            model_used=(output.metadata or {}).get("model_used"),
            metadata={"sources": self._format_sources(output)},
        )
        tool_calls = output.extract_tool_calls() or \
            (output.metadata or {}).get("tool_calls", [])
        if tool_calls:
            self.traces.insert_tool_calls(msg_id, tool_calls)
        timing.stamp("inserts_finished")
        self.conversations.record_timing(msg_id, timing)
        return {
            "conversation_id": conversation_id,
            "message_id": msg_id,
            "answer": output.answer,
            "sources": self._format_sources(output),
            "metadata": {k: v for k, v in (output.metadata or {}).items()
                         if k in ("model_used", "pipeline_used", "usage",
                                  "steps", "condensed_output")},
            "timing": timing.durations(),
        }

    # ------------------------------------------------------------------ api
    def __call__(self, message: str, *, conversation_id: Optional[int] = None,
                 user_id: Optional[int] = None,
                 user_email: Optional[str] = None,
                 model_override: Optional[str] = None,
                 client_sent: Optional[float] = None) -> dict:
        from archi_tpu_torch.utils.metrics import METRICS

        timing = TimingRecorder(client_sent)
        timing.stamp("server_received")
        with self.lock:
            timing.stamp("lock_acquisition")
            conversation_id, history, enabled = self._prepare(
                conversation_id, user_id, message, timing
            )
            saved_llms = self._resolve_model_override(
                user_email, model_override)
            try:
                timing.stamp("chain_started")
                with METRICS.timer("archi_chat_duration_seconds"):
                    output = self.archi.invoke(history=history,
                                               enabled_ids=enabled)
                timing.stamp("chain_finished")
            finally:
                self.archi.pipeline.llms = saved_llms
            METRICS.inc("archi_chat_messages")
            return self._finalize(conversation_id, message, output, timing)

    def stream(self, message: str, *, conversation_id: Optional[int] = None,
               user_id: Optional[int] = None,
               user_email: Optional[str] = None,
               model_override: Optional[str] = None,
               client_sent: Optional[float] = None) -> Iterator[dict]:
        """Yields SSE-able event dicts; writes the agent trace live."""
        timing = TimingRecorder(client_sent)
        timing.stamp("server_received")
        with self.lock:
            timing.stamp("lock_acquisition")
            conversation_id, history, enabled = self._prepare(
                conversation_id, user_id, message, timing
            )
            saved_llms = self._resolve_model_override(
                user_email, model_override)
            trace_id = self.traces.create_trace(conversation_id)
            yield {"type": "trace_start", "trace_id": trace_id,
                   "conversation_id": conversation_id}
            timing.stamp("chain_started")
            final: Optional[PipelineOutput] = None
            cancelled = False
            try:
                for out in self.archi.stream(history=history,
                                             enabled_ids=enabled):
                    if self.traces.is_cancelled(trace_id):
                        cancelled = True
                        break
                    if out.final:
                        final = out
                        continue
                    event = (out.metadata or {}).get("event", {})
                    self.traces.append_event(trace_id, event)
                    yield event
            finally:
                self.archi.pipeline.llms = saved_llms
            timing.stamp("chain_finished")
            if cancelled or final is None:
                self.traces.finish_trace(trace_id, status="cancelled")
                yield {"type": "cancelled", "trace_id": trace_id}
                return
            result = self._finalize(conversation_id, message, final, timing)
            usage = (final.metadata or {}).get("usage", {})
            self.traces.finish_trace(
                trace_id, status="completed",
                message_id=result["message_id"],
                total_tokens=sum(usage.values()) if usage else 0,
                total_tool_calls=len((final.metadata or {}).get(
                    "tool_calls", [])),
            )
            yield {"type": "final", **result, "trace_id": trace_id}

    # -------------------------------------------------------------------- AB
    def ab_compare(self, message: str, model_a: str, model_b: str, *,
                   conversation_id: Optional[int] = None,
                   user_id: Optional[int] = None) -> dict:
        """Run the same question against two models (reference A/B methods
        app.py:672-853)."""
        with self.lock:
            timing = TimingRecorder()
            conversation_id, history, _enabled = self._prepare(
                conversation_id, user_id, message, timing
            )
            answers = {}
            saved_llms = dict(self.archi.pipeline.llms)
            try:
                for label, ref in (("a", model_a), ("b", model_b)):
                    self._resolve_model_override(None, ref)
                    out = self.archi.invoke(history=history)
                    answers[label] = out.answer
            finally:
                self.archi.pipeline.llms = saved_llms
            ab_id = self.conversations.create_ab_comparison(
                conversation_id, message, answers["a"], answers["b"],
                model_a, model_b,
            )
            return {"comparison_id": ab_id, "conversation_id": conversation_id,
                    "answer_a": answers["a"], "answer_b": answers["b"],
                    "model_a": model_a, "model_b": model_b}
