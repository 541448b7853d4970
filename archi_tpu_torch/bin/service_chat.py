"""Chat service entry point: answer users' questions over the port's store.

Counterpart of ``archi_tpu/bin/service_chat.py`` (reference
``src/bin/service_chat.py:14``), over the port's ``build_context``.  In the
deployment's shape the chat process holds no index: with ``remote_engine``
(as ``main`` runs it) it queries the data-manager service
(``bin/service_data_manager.py``), which owns the index on the card, over
HTTP through ``RemoteVectorStore``.  Without it the context builds its own
store, on the card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_data_manager config.yaml
    python -m archi_tpu_torch.bin.service_chat config.yaml

(a YAML config needs PyYAML; ``build_app(overrides=...)`` takes the same
settings as a dict).  ``DATA_MANAGER_TOKEN`` in the environment is sent on
every query to the data-manager and its proxy.
"""

from __future__ import annotations

import os
import sys
import threading

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.config.manager import ConfigurationManager
from archi_tpu_torch.engine.remote_vectorstore import RemoteVectorStore
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.pipelines.agents.agent_spec import AgentStore
from archi_tpu_torch.web.chat_app import create_chat_app
from archi_tpu_torch.web.chat_wrapper import ChatWrapper
from archi_tpu_torch.web.frontend import FRONTEND_HTML


def resolve_engine_url(config: dict) -> str | None:
    """The data-manager's URL a standalone chat process queries: explicit
    ``services.chat.engine_url`` wins; else the enabled data_manager
    service's host and port."""
    chat_cfg = config.get("services", {}).get("chat", {})
    if chat_cfg.get("engine_url"):
        return chat_cfg["engine_url"]
    dm = config.get("services", {}).get("data_manager", {})
    if dm.get("enabled") and dm.get("port"):
        host = dm.get("host", "127.0.0.1")
        if host in ("0.0.0.0", ""):
            host = "127.0.0.1"
        return f"http://{host}:{dm['port']}"
    return None


def make_agent_resolver(agent_store, config_service, config, vectorstore):
    """() → Optional[Archi] for the dynamic-config ``active_agent``.

    Caches the built agent per (name, spec mtime) so selecting an agent
    over HTTP (PUT /api/agents/active) takes effect on the next message
    without paying a rebuild per request."""
    cache: dict = {}

    def resolver():
        name = None
        if config_service is not None:
            name = config_service.get("active_agent")
        if not name:
            return None
        spec = agent_store.get(name)
        if spec is None:
            return None
        mtime = os.path.getmtime(spec.source_path) if spec.source_path else 0
        key = (name, mtime)
        if cache.get("key") != key:
            from archi_tpu_torch.pipelines.agents.toolbox import (
                agent_from_spec,
            )

            agent = agent_from_spec(spec, config)
            archi = Archi("BaseReActAgent", config=config,
                          vectorstore=vectorstore)
            archi.pipeline = agent  # the spec-configured instance
            cache["key"] = key
            cache["archi"] = archi
        return cache["archi"]

    return resolver


def build_app(config_paths=(), overrides=None, ctx=None, *,
              remote_engine: bool = False, device=None, devices=None):
    """→ (app, ctx), in the JAX package's order: the engine URL, the
    context, the ``Archi`` of ``active_pipeline``, the agents under
    ``<data_path>/agents``, the wrapper and the app.

    ``ctx`` defaults to ``build_context(config_paths, overrides,
    device=device, devices=devices)``; with ``remote_engine`` and a
    data-manager URL (``resolve_engine_url``) its store is a
    ``RemoteVectorStore`` on that URL, and nothing is placed on a
    device."""
    if ctx is None and remote_engine:
        cm = ConfigurationManager(config_paths, overrides)
        url = resolve_engine_url(cm.config)
        vs = RemoteVectorStore(
            url, auth_token=os.environ.get("DATA_MANAGER_TOKEN")
        ) if url else None
        ctx = build_context(config_paths, overrides, vectorstore=vs,
                            device=device, devices=devices)
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    pipeline = ctx.config.get("active_pipeline", "QAPipeline")
    archi = Archi(pipeline, config=ctx.config, vectorstore=ctx.vectorstore)

    agents_dir = os.path.join(
        ctx.config["data_manager"]["data_path"], "agents")
    agent_store = AgentStore(agents_dir)
    wrapper = ChatWrapper(
        archi, ctx.conversations, ctx.traces,
        source_score_threshold=ctx.config.get("chat", {}).get(
            "source_score_threshold", 0.0),
        byok_resolver=ctx.byok_resolver,
        catalog=ctx.catalog,
        agent_resolver=make_agent_resolver(
            agent_store, ctx.config_service, ctx.config, ctx.vectorstore),
    )
    app = create_chat_app(
        chat_wrapper=wrapper,
        conversations=ctx.conversations,
        traces=ctx.traces,
        config_service=ctx.config_service,
        user_service=ctx.users,
        byok_store=ctx.byok_store,
        catalog=ctx.catalog,
        app_db=ctx.app_db,
        agent_store=agent_store,
        prompt_service=ctx.prompts,
        data_manager_url=resolve_engine_url(ctx.config),
        data_manager_token=os.environ.get("DATA_MANAGER_TOKEN"),
        jwt_secret=os.environ.get("JWT_SECRET"),
        require_auth=bool(os.environ.get("REQUIRE_AUTH")),
        frontend_html=FRONTEND_HTML,
    )
    return app, ctx


def main() -> None:
    app, ctx = build_app(sys.argv[1:], remote_engine=True)
    svc = ctx.config["services"]["chat"]
    # warm the query path off the request path, where it would hold the
    # chat lock (a remote store checks that the data-manager answers)
    threading.Thread(target=ctx.vectorstore.warmup, daemon=True,
                     name="engine-warmup").start()
    print(f"chat service on {svc['host']}:{svc['port']}")
    app.serve(svc["host"], svc["port"])


if __name__ == "__main__":
    main()
