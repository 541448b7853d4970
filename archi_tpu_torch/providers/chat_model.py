"""Chat model clients: one interface, HTTP backends per provider family.

Copy of ``archi_tpu/providers/chat_model.py``.

The reference returns LangChain ``BaseChatModel`` objects (``ChatOpenAI``,
``ChatAnthropic``, ...; ``src/archi/providers/*_provider.py``).  Here the
interface is our own (``invoke``/``stream`` over ``Message`` lists with
native tool calling) and each backend speaks its provider's REST protocol
via ``requests`` — this is I/O plumbing, not compute (SURVEY.md §7 stage 7).

``EchoChatModel``/``ScriptedChatModel`` provide deterministic offline
models: the test double the reference gets from pointing smoke tests at a
tiny Ollama (SURVEY.md §4 "fake backend").
"""

from __future__ import annotations

import json
import uuid
from abc import ABC, abstractmethod
from typing import Any, Callable, Iterator, Optional, Sequence

from archi_tpu_torch.utils.messages import Message, ToolCall


class BaseChatModel(ABC):
    model_name: str = "unknown"
    temperature: float = 0.7

    @abstractmethod
    def invoke(self, messages: Sequence[Message], *,
               tools: Optional[list[dict]] = None, **kw) -> Message:
        ...

    def stream(self, messages: Sequence[Message], *,
               tools: Optional[list[dict]] = None, **kw) -> Iterator[Message]:
        """Default streaming = one final chunk; HTTP models override with
        SSE streaming."""
        yield self.invoke(messages, tools=tools, **kw)


def tool_to_openai_schema(tool: dict) -> dict:
    """{name, description, parameters} → OpenAI function-call schema."""
    return {
        "type": "function",
        "function": {
            "name": tool["name"],
            "description": tool.get("description", ""),
            "parameters": tool.get("parameters",
                                   {"type": "object", "properties": {}}),
        },
    }


class OpenAICompatChatModel(BaseChatModel):
    """OpenAI chat-completions protocol — covers OpenAI, OpenRouter, vLLM,
    and Ollama's /v1 endpoint (reference local_provider openai_compat mode,
    ``local_provider.py:109``)."""

    def __init__(self, model_name: str, *, api_key: str = "",
                 base_url: str = "https://api.openai.com/v1",
                 temperature: float = 0.7, max_tokens: Optional[int] = None,
                 extra_headers: Optional[dict] = None, timeout: float = 120.0):
        self.model_name = model_name
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.extra_headers = extra_headers or {}
        self.timeout = timeout

    # -------------------------------------------------------------- helpers
    def _payload(self, messages, tools, stream=False, **kw):
        msgs = []
        for m in messages:
            d: dict[str, Any] = {"role": m.role, "content": m.content}
            if m.role == "assistant" and m.tool_calls:
                d["tool_calls"] = [
                    {"id": tc.id, "type": "function",
                     "function": {"name": tc.name,
                                  "arguments": json.dumps(tc.args)}}
                    for tc in m.tool_calls
                ]
            if m.role == "tool":
                d["tool_call_id"] = m.tool_call_id
            msgs.append(d)
        payload = {
            "model": self.model_name,
            "messages": msgs,
            "temperature": self.temperature,
            "stream": stream,
        }
        if self.max_tokens:
            payload["max_tokens"] = self.max_tokens
        if tools:
            payload["tools"] = [tool_to_openai_schema(t) for t in tools]
        payload.update(kw)
        return payload

    def _headers(self):
        h = {"Content-Type": "application/json", **self.extra_headers}
        if self.api_key:
            h["Authorization"] = f"Bearer {self.api_key}"
        return h

    def _parse_message(self, m: dict, usage: dict) -> Message:
        tool_calls = [
            ToolCall(
                name=tc["function"]["name"],
                args=json.loads(tc["function"].get("arguments") or "{}"),
                id=tc.get("id") or str(uuid.uuid4()),
            )
            for tc in m.get("tool_calls") or []
        ]
        return Message("assistant", m.get("content") or "",
                       tool_calls=tool_calls,
                       usage={
                           "input_tokens": usage.get("prompt_tokens", 0),
                           "output_tokens": usage.get("completion_tokens", 0),
                       })

    # ------------------------------------------------------------------ api
    def invoke(self, messages, *, tools=None, **kw) -> Message:
        import requests

        r = requests.post(
            f"{self.base_url}/chat/completions",
            headers=self._headers(),
            json=self._payload(messages, tools, **kw),
            timeout=self.timeout,
        )
        r.raise_for_status()
        data = r.json()
        return self._parse_message(
            data["choices"][0]["message"], data.get("usage") or {}
        )

    def stream(self, messages, *, tools=None, **kw) -> Iterator[Message]:
        import requests

        r = requests.post(
            f"{self.base_url}/chat/completions",
            headers=self._headers(),
            json=self._payload(messages, tools, stream=True, **kw),
            timeout=self.timeout, stream=True,
        )
        r.raise_for_status()
        # accumulate tool-call fragments; yield content deltas
        acc_calls: dict[int, dict] = {}
        for line in r.iter_lines():
            if not line or not line.startswith(b"data:"):
                continue
            data = line[5:].strip()
            if data == b"[DONE]":
                break
            chunk = json.loads(data)
            delta = chunk["choices"][0].get("delta") or {}
            if delta.get("content"):
                yield Message("assistant", delta["content"],
                              metadata={"delta": True})
            for tc in delta.get("tool_calls") or []:
                slot = acc_calls.setdefault(
                    tc.get("index", 0),
                    {"id": "", "name": "", "arguments": ""},
                )
                if tc.get("id"):
                    slot["id"] = tc["id"]
                fn = tc.get("function") or {}
                if fn.get("name"):
                    slot["name"] += fn["name"]
                if fn.get("arguments"):
                    slot["arguments"] += fn["arguments"]
        if acc_calls:
            calls = [
                ToolCall(name=c["name"],
                         args=json.loads(c["arguments"] or "{}"),
                         id=c["id"] or str(uuid.uuid4()))
                for c in acc_calls.values()
            ]
            yield Message("assistant", "", tool_calls=calls)


class AnthropicChatModel(BaseChatModel):
    """Anthropic Messages API."""

    def __init__(self, model_name: str, *, api_key: str = "",
                 base_url: str = "https://api.anthropic.com",
                 temperature: float = 0.7, max_tokens: int = 4096,
                 timeout: float = 120.0):
        self.model_name = model_name
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.temperature = temperature
        self.max_tokens = max_tokens
        self.timeout = timeout

    def invoke(self, messages, *, tools=None, **kw) -> Message:
        import requests

        system_parts = [m.content for m in messages if m.role == "system"]
        msgs = []
        for m in messages:
            if m.role == "system":
                continue
            if m.role == "tool":
                msgs.append({
                    "role": "user",
                    "content": [{
                        "type": "tool_result",
                        "tool_use_id": m.tool_call_id,
                        "content": m.content,
                    }],
                })
            elif m.role == "assistant" and m.tool_calls:
                content: list[dict] = []
                if m.content:
                    content.append({"type": "text", "text": m.content})
                content += [
                    {"type": "tool_use", "id": tc.id, "name": tc.name,
                     "input": tc.args}
                    for tc in m.tool_calls
                ]
                msgs.append({"role": "assistant", "content": content})
            else:
                msgs.append({"role": m.role, "content": m.content})
        payload: dict[str, Any] = {
            "model": self.model_name,
            "messages": msgs,
            "max_tokens": self.max_tokens,
            "temperature": self.temperature,
        }
        if system_parts:
            payload["system"] = "\n\n".join(system_parts)
        if tools:
            payload["tools"] = [
                {"name": t["name"], "description": t.get("description", ""),
                 "input_schema": t.get("parameters",
                                       {"type": "object", "properties": {}})}
                for t in tools
            ]
        payload.update(kw)
        r = requests.post(
            f"{self.base_url}/v1/messages",
            headers={"x-api-key": self.api_key,
                     "anthropic-version": "2023-06-01",
                     "content-type": "application/json"},
            json=payload, timeout=self.timeout,
        )
        r.raise_for_status()
        data = r.json()
        text = "".join(b.get("text", "") for b in data.get("content", [])
                       if b.get("type") == "text")
        calls = [ToolCall(name=b["name"], args=b.get("input") or {},
                          id=b["id"])
                 for b in data.get("content", []) if b.get("type") == "tool_use"]
        usage = data.get("usage") or {}
        return Message("assistant", text, tool_calls=calls,
                       usage={"input_tokens": usage.get("input_tokens", 0),
                              "output_tokens": usage.get("output_tokens", 0)})


class GeminiChatModel(BaseChatModel):
    """Google Generative Language API (generateContent)."""

    def __init__(self, model_name: str, *, api_key: str = "",
                 base_url: str = "https://generativelanguage.googleapis.com",
                 temperature: float = 0.7, timeout: float = 120.0):
        self.model_name = model_name
        self.api_key = api_key
        self.base_url = base_url.rstrip("/")
        self.temperature = temperature
        self.timeout = timeout

    def invoke(self, messages, *, tools=None, **kw) -> Message:
        import requests

        contents = []
        system_text = "\n\n".join(
            m.content for m in messages if m.role == "system"
        )
        for m in messages:
            if m.role == "system":
                continue
            role = "model" if m.role == "assistant" else "user"
            contents.append({"role": role, "parts": [{"text": m.content}]})
        payload: dict[str, Any] = {
            "contents": contents,
            "generationConfig": {"temperature": self.temperature},
        }
        if system_text:
            payload["systemInstruction"] = {"parts": [{"text": system_text}]}
        if tools:
            payload["tools"] = [{
                "functionDeclarations": [
                    {"name": t["name"], "description": t.get("description", ""),
                     "parameters": t.get("parameters")}
                    for t in tools
                ]
            }]
        r = requests.post(
            f"{self.base_url}/v1beta/models/{self.model_name}:generateContent",
            params={"key": self.api_key}, json=payload, timeout=self.timeout,
        )
        r.raise_for_status()
        data = r.json()
        parts = data["candidates"][0]["content"].get("parts", [])
        text = "".join(p.get("text", "") for p in parts if "text" in p)
        calls = [
            ToolCall(name=p["functionCall"]["name"],
                     args=p["functionCall"].get("args") or {},
                     id=str(uuid.uuid4()))
            for p in parts if "functionCall" in p
        ]
        return Message("assistant", text, tool_calls=calls)


class EchoChatModel(BaseChatModel):
    """Offline deterministic model: echoes the last user message.  The
    zero-egress stand-in for a tiny Ollama model in smoke tests."""

    model_name = "echo"

    def __init__(self, prefix: str = "ECHO: "):
        self.prefix = prefix

    def invoke(self, messages, *, tools=None, **kw) -> Message:
        last = next((m for m in reversed(messages) if m.role == "user"),
                    None)
        return Message("assistant",
                       self.prefix + (last.content if last else ""),
                       usage={"input_tokens": sum(len(m.content.split())
                                                  for m in messages),
                              "output_tokens": 8})


class ScriptedChatModel(BaseChatModel):
    """Returns/streams a scripted sequence of Messages (or callables taking
    the message list).  Drives agent-loop tests deterministically."""

    model_name = "scripted"

    def __init__(self, script: Sequence[Message | Callable]):
        self._script = list(script)
        self._i = 0

    def invoke(self, messages, *, tools=None, **kw) -> Message:
        if self._i >= len(self._script):
            return Message("assistant", "(script exhausted)")
        step = self._script[self._i]
        self._i += 1
        return step(messages) if callable(step) else step
