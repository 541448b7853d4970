"""MCP tool integration.

Copy of ``archi_tpu/pipelines/agents/mcp.py``.

Mirrors the reference's MCP adapter
(``src/archi/pipelines/agents/tools/mcp.py:13`` via
``langchain-mcp-adapters``; async tools patched sync through the
``AsyncLoopThread`` singleton, ``utils/mcp_utils.py:8``,
``base_react.py:1060-1104``).  This implementation speaks MCP's JSON-RPC
over stdio directly (initialize / tools-list / tools-call) and wraps each
remote tool as a local ``Tool`` whose calls run synchronously.
"""

from __future__ import annotations

import json
import subprocess
import threading
from typing import Any, Optional

from archi_tpu_torch.pipelines.agents.tools.base import Tool


class AsyncLoopThread:
    """Singleton background event loop so async integrations can be driven
    synchronously (reference ``utils/mcp_utils.py:8``)."""

    _instance: Optional["AsyncLoopThread"] = None
    _lock = threading.Lock()

    def __new__(cls):
        with cls._lock:
            if cls._instance is None:
                import asyncio

                inst = super().__new__(cls)
                inst.loop = asyncio.new_event_loop()
                inst.thread = threading.Thread(
                    target=inst.loop.run_forever, daemon=True,
                    name="async-loop",
                )
                inst.thread.start()
                cls._instance = inst
            return cls._instance

    def run(self, coro, timeout: float = 60.0):
        import asyncio

        fut = asyncio.run_coroutine_threadsafe(coro, self.loop)
        return fut.result(timeout=timeout)


class MCPStdioClient:
    """Minimal MCP client over a stdio server subprocess."""

    def __init__(self, command: list[str], *, env: Optional[dict] = None,
                 timeout: float = 30.0):
        self.proc = subprocess.Popen(
            command, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            env=env, text=True, bufsize=1,
        )
        self.timeout = timeout
        self._id = 0
        self._lock = threading.Lock()
        self._rpc("initialize", {
            "protocolVersion": "2024-11-05",
            "capabilities": {},
            "clientInfo": {"name": "archi-tpu", "version": "0.1"},
        })
        self._notify("notifications/initialized", {})

    def _send(self, obj: dict) -> None:
        assert self.proc.stdin is not None
        self.proc.stdin.write(json.dumps(obj) + "\n")
        self.proc.stdin.flush()

    def _rpc(self, method: str, params: dict) -> Any:
        with self._lock:
            self._id += 1
            rid = self._id
            self._send({"jsonrpc": "2.0", "id": rid, "method": method,
                        "params": params})
            assert self.proc.stdout is not None
            while True:
                line = self.proc.stdout.readline()
                if not line:
                    raise RuntimeError("MCP server closed")
                msg = json.loads(line)
                if msg.get("id") == rid:
                    if "error" in msg:
                        raise RuntimeError(str(msg["error"]))
                    return msg.get("result")

    def _notify(self, method: str, params: dict) -> None:
        self._send({"jsonrpc": "2.0", "method": method, "params": params})

    def list_tools(self) -> list[dict]:
        return (self._rpc("tools/list", {}) or {}).get("tools", [])

    def call_tool(self, name: str, args: dict) -> str:
        result = self._rpc("tools/call", {"name": name, "arguments": args})
        parts = (result or {}).get("content", [])
        return "\n".join(p.get("text", "") for p in parts
                         if p.get("type") == "text")

    def close(self) -> None:
        try:
            self.proc.terminate()
        except Exception:
            pass


def initialize_mcp_tools(servers: dict[str, dict]) -> list[Tool]:
    """{name: {command: [...], env: {...}}} → local Tool wrappers (the
    reference's MultiServerMCPClient equivalent, ``mcp.py:13``)."""
    tools: list[Tool] = []
    for server_name, spec in (servers or {}).items():
        try:
            client = MCPStdioClient(spec["command"], env=spec.get("env"))
        except Exception:
            continue
        for t in client.list_tools():
            def make_fn(c=client, tool_name=t["name"]):
                return lambda **args: c.call_tool(tool_name, args)

            tools.append(Tool(
                name=f"{server_name}__{t['name']}",
                description=t.get("description", ""),
                fn=make_fn(),
                parameters=t.get("inputSchema",
                                 {"type": "object", "properties": {}}),
            ))
    return tools
