"""Chat service: the reference chat_app's HTTP surface over the port's stack.

Counterpart of ``archi_tpu/web/chat_app.py``; the code is the reference's
but in two places.  The data-manager proxy (``/api/dm/*``) goes over the
standard library's ``urllib`` (the JAX package's uses ``requests``, which
the card's machine lacks), passing the data-manager's status code and JSON
body through as the reference does; ``/api/v2/info`` names the port's
package and a PyTorch/CUDA engine.

Mirrors the route families of the reference's ``FlaskAppWrapper``
(``src/interfaces/chat_app/app.py:2097``, ~70 routes) and REST v2 blueprint
(``chat_app/api.py``): chat + streaming (``:2172-2174``), conversations
(``:2185-2190``), A/B (``:2193-2196``), traces + cancel (``:2199-2202``),
providers/BYOK (``:2205-2211,3113-3416``), config + audit
(``api.py:323-506``), analytics (``api.py:713,760``), users/preferences
(``api.py:157,192``), and auth (JWT header / dev identity).
"""

from __future__ import annotations

import json
from typing import Optional

from archi_tpu_torch.utils.rbac.jwt_parser import extract_identity
from archi_tpu_torch.utils.rbac.permissions import Permission, has_permission
from archi_tpu_torch.web.framework import (
    App, Request, Response, error_response, json_response, sse_response,
)


def create_chat_app(
    *,
    chat_wrapper,
    conversations,
    traces,
    config_service=None,
    user_service=None,
    byok_store=None,
    catalog=None,
    app_db=None,
    agent_store=None,
    prompt_service=None,
    prompts_dir: Optional[str] = None,
    session_service=None,
    oauth_exchange=None,
    data_manager_url: Optional[str] = None,
    data_manager_token: Optional[str] = None,
    jwt_secret: Optional[str] = None,
    require_auth: bool = False,
    frontend_html: Optional[str] = None,
) -> App:
    app = App("chat")
    if session_service is None and user_service is not None:
        from archi_tpu_torch.utils.sessions import SessionService

        session_service = SessionService(jwt_secret)

    # auth endpoints must stay reachable without a session, or nobody can
    # ever log in under require_auth
    _AUTH_OPEN = ("/api/auth/login", "/api/auth/callback")

    # ------------------------------------------------------------------ auth
    def auth_middleware(req: Request) -> Optional[Response]:
        token = req.headers.get("x-auth-token") or (
            req.headers.get("authorization", "").removeprefix("Bearer ").strip()
            or None
        )
        identity = None
        # 1) session cookie (issued by /api/auth/login or the OAuth callback)
        if session_service is not None:
            from archi_tpu_torch.utils.sessions import SessionService as _SS

            stoken = _SS.token_from_cookie_header(
                req.headers.get("cookie", ""))
            if stoken:
                email = session_service.verify(stoken)
                if email:
                    identity = {"email": email, "name": "", "roles": ["user"]}
        # 2) bearer / JWT header
        if identity is None and token:
            try:
                identity = extract_identity(token, jwt_secret)
            except ValueError as e:
                return error_response(f"invalid token: {e}", 401)
        elif identity is None and req.headers.get("x-user-email") \
                and not require_auth and jwt_secret is None:
            # dev-mode identity header; NEVER trusted once real auth (JWT
            # secret or require_auth) is configured — it would be a trivial
            # impersonation vector otherwise.
            identity = {"email": req.headers["x-user-email"],
                        "name": "", "roles": ["user"]}
        if identity is None:
            if require_auth and req.path.startswith("/api/") \
                    and req.path not in _AUTH_OPEN:
                return error_response("authentication required", 401)
            identity = {"email": None, "name": "", "roles": ["user"]}
        if user_service is not None and identity.get("email"):
            uid = user_service.create_user(identity["email"],
                                           name=identity.get("name", ""))
            identity["user_id"] = uid
            stored = user_service.get_user(identity["email"]) or {}
            identity["roles"] = sorted(
                set(identity["roles"]) | set(stored.get("roles", []))
            )
        req.context["identity"] = identity
        return None

    app.use(auth_middleware)

    def _require(req: Request, perm: Permission):
        roles = req.context["identity"]["roles"]
        if not has_permission(roles, perm):
            raise PermissionError(f"requires {perm.value}")

    def _uid(req: Request) -> Optional[int]:
        return req.context["identity"].get("user_id")

    # ------------------------------------------------------------------ chat
    @app.post("/api/get_chat_response")
    def chat(req: Request):
        _require(req, Permission.CHAT_USE)
        body = req.json()
        if not body.get("message"):
            raise ValueError("missing 'message'")
        return chat_wrapper(
            body["message"],
            conversation_id=body.get("conversation_id"),
            user_id=_uid(req),
            user_email=req.context["identity"].get("email"),
            model_override=body.get("model"),
            client_sent=body.get("client_sent"),
        )

    @app.post("/api/get_chat_response_stream")
    def chat_stream(req: Request):
        _require(req, Permission.CHAT_STREAM)
        body = req.json()
        if not body.get("message"):
            raise ValueError("missing 'message'")
        return sse_response(chat_wrapper.stream(
            body["message"],
            conversation_id=body.get("conversation_id"),
            user_id=_uid(req),
            user_email=req.context["identity"].get("email"),
            model_override=body.get("model"),
            client_sent=body.get("client_sent"),
        ))

    # --------------------------------------------------------- conversations
    @app.get("/api/conversations")
    def list_convos(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        return conversations.list_conversations(_uid(req))

    @app.get("/api/conversations/<cid>")
    def get_convo(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        cid = int(req.path_params["cid"])
        if _uid(req) is not None and not conversations.user_owns(cid, _uid(req)):
            conv = conversations.get_conversation(cid)
            if conv and conv.get("user_id") is not None:
                raise PermissionError("not your conversation")
        return conversations.get_messages(cid)

    def _check_ownership(req: Request, cid: int) -> None:
        if _uid(req) is None:
            return
        conv = conversations.get_conversation(cid)
        if conv and conv.get("user_id") is not None and \
                conv["user_id"] != _uid(req):
            raise PermissionError("not your conversation")

    def _check_message_ownership(req: Request, mid: int) -> None:
        """Resolve message → conversation → owner.  Ids are sequential, so
        without this any authenticated user could read/write other users'
        per-message state by enumeration."""
        msg = conversations.get_message(mid)
        if msg is not None:
            _check_ownership(req, msg["conversation_id"])

    def _check_trace_ownership(req: Request, tid: int):
        tr = traces.get_trace(tid)
        if tr is not None and tr.get("conversation_id") is not None:
            _check_ownership(req, tr["conversation_id"])
        return tr

    @app.delete("/api/conversations/<cid>")
    def delete_convo(req: Request):
        _require(req, Permission.CHAT_HISTORY_DELETE)
        cid = int(req.path_params["cid"])
        _check_ownership(req, cid)
        conversations.delete_conversation(cid)
        return {"ok": True}

    @app.put("/api/conversations/<cid>")
    def rename_convo(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        cid = int(req.path_params["cid"])
        _check_ownership(req, cid)
        conversations.rename_conversation(cid, req.json().get("title", ""))
        return {"ok": True}

    # ----------------------------------------------- document selection
    # 3-tier per-conversation document enablement (reference
    # api.py:548-711, init.sql:315-336).
    @app.get("/api/conversations/<cid>/documents")
    def conv_documents(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        if catalog is None:
            return []
        cid = req.path_params["cid"]
        enabled = catalog.enabled_hashes(cid)
        docs = catalog.list_documents()
        return [
            {"resource_hash": d["resource_hash"],
             "display_name": d["display_name"],
             "source_type": d["source_type"],
             "enabled": enabled is None or d["resource_hash"] in enabled}
            for d in docs
        ]

    @app.put("/api/conversations/<cid>/documents")
    def set_conv_documents(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        if catalog is None:
            return error_response("catalog not configured", 501)
        cid = req.path_params["cid"]
        for h, enabled in req.json().items():
            catalog.set_document_enabled(cid, h, bool(enabled))
        return {"ok": True}

    # ------------------------------------------------ data-manager proxy
    # The chat UI talks to one origin; data operations proxy to the
    # data-manager service (reference chat->data-manager proxy,
    # app.py:2139-2146).
    def _dm(req: Request, method: str, path: str, json_body=None):
        if data_manager_url is None:
            return error_response("data manager not configured", 501)
        import urllib.error
        import urllib.request

        headers = {}
        if data_manager_token:
            headers["x-data-token"] = data_manager_token
        data = None
        if json_body is not None:
            data = json.dumps(json_body).encode()
            headers["Content-Type"] = "application/json"
        rq = urllib.request.Request(data_manager_url.rstrip("/") + path,
                                    data=data, headers=headers, method=method)
        try:
            with urllib.request.urlopen(rq, timeout=300) as r:
                return json_response(json.loads(r.read()), r.status)
        except urllib.error.HTTPError as e:
            return json_response(json.loads(e.read()), e.code)

    @app.get("/api/dm/grouped")
    def dm_grouped(req: Request):
        _require(req, Permission.DATA_READ)
        return _dm(req, "GET", "/api/data/grouped")

    @app.get("/api/dm/status")
    def dm_status(req: Request):
        _require(req, Permission.DATA_READ)
        return _dm(req, "GET", "/api/ingestion/status")

    @app.post("/api/dm/upload")
    def dm_upload(req: Request):
        _require(req, Permission.DATA_UPLOAD)
        return _dm(req, "POST", "/api/upload", req.json())

    @app.delete("/api/dm/documents/<resource_hash>")
    def dm_delete(req: Request):
        _require(req, Permission.DATA_DELETE)
        return _dm(req, "DELETE",
                   f"/api/documents/{req.path_params['resource_hash']}")

    @app.post("/api/dm/links")
    def dm_add_link(req: Request):
        _require(req, Permission.DATA_UPLOAD)
        return _dm(req, "POST", "/api/links", req.json())

    @app.post("/api/dm/git")
    def dm_add_git(req: Request):
        _require(req, Permission.DATA_UPLOAD)
        return _dm(req, "POST", "/api/git", req.json())

    @app.get("/api/dm/schedules")
    def dm_schedules(req: Request):
        _require(req, Permission.DATA_READ)
        return _dm(req, "GET", "/api/schedules")

    @app.put("/api/dm/schedules")
    def dm_set_schedules(req: Request):
        _require(req, Permission.DATA_INGEST)
        return _dm(req, "PUT", "/api/schedules", req.json())

    @app.post("/api/dm/retry")
    def dm_retry(req: Request):
        _require(req, Permission.DATA_INGEST)
        return _dm(req, "POST", "/api/ingestion/retry", req.json())

    @app.get("/api/dm/stats")
    def dm_stats(req: Request):
        _require(req, Permission.DATA_READ)
        return _dm(req, "GET", "/api/stats")

    # -------------------------------------------------- admin DB console
    @app.get("/api/admin/db/tables")
    def admin_db_tables(req: Request):
        """Table listing for the console (reference app.py:2255)."""
        _require(req, Permission.ADMIN_DB)
        if app_db is None:
            return error_response("app db not configured", 501)
        try:
            rows = app_db.query(
                "SELECT name FROM sqlite_master WHERE type='table' "
                "ORDER BY name")
        except Exception:
            rows = app_db.query(
                "SELECT table_name AS name FROM information_schema.tables "
                "WHERE table_schema='public' ORDER BY table_name")
        return [r["name"] for r in rows]

    @app.post("/api/admin/db")
    def admin_db(req: Request):
        """Read-only SQL console (reference admin DB viewer,
        app.py:2254-2256); admin-gated, SELECT-only."""
        _require(req, Permission.ADMIN_DB)
        if app_db is None:
            return error_response("app db not configured", 501)
        sql = (req.json().get("sql") or "").strip().rstrip(";").strip()
        # Single SELECT only: some DBAPI drivers (psycopg2) execute
        # multi-statement strings, so 'select 1; update ...' would pass a
        # prefix-only check and commit the write.
        if not sql.lower().startswith("select") or ";" in sql:
            return error_response("a single SELECT statement only", 400)
        try:
            rows = app_db.query(sql)
        except Exception as e:
            return error_response(f"query error: {e}", 400)
        return [dict(r) for r in rows[:500]]

    @app.post("/api/feedback")
    def feedback(req: Request):
        _require(req, Permission.CHAT_USE)
        body = req.json()
        mid = int(body["message_id"])
        _check_message_ownership(req, mid)
        fid = conversations.add_feedback(
            mid, body.get("rating", "like"), body.get("comment", ""),
        )
        return {"feedback_id": fid}

    # ---------------------------------------------------------------- traces
    @app.get("/api/trace/<tid>")
    def get_trace(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        tr = _check_trace_ownership(req, int(req.path_params["tid"]))
        if tr is None:
            return error_response("trace not found", 404)
        return tr

    @app.post("/api/cancel_stream")
    def cancel_stream(req: Request):
        _require(req, Permission.CHAT_USE)
        tid = int(req.json()["trace_id"])
        _check_trace_ownership(req, tid)
        return {"cancelled": traces.cancel(tid)}

    @app.get("/api/tool_calls/<mid>")
    def tool_calls(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        mid = int(req.path_params["mid"])
        _check_message_ownership(req, mid)
        return traces.get_tool_calls(mid)

    @app.get("/api/trace/message/<mid>")
    def trace_by_message(req: Request):
        _require(req, Permission.CHAT_HISTORY_READ)
        mid = int(req.path_params["mid"])
        _check_message_ownership(req, mid)
        tr = traces.get_trace_by_message(mid)
        if tr is None:
            return error_response("trace not found", 404)
        return tr

    # --------------------------------------------------------------------- AB
    @app.post("/api/ab_compare")
    def ab_compare(req: Request):
        _require(req, Permission.CHAT_USE)
        body = req.json()
        return chat_wrapper.ab_compare(
            body["message"], body["model_a"], body["model_b"],
            conversation_id=body.get("conversation_id"), user_id=_uid(req),
        )

    @app.post("/api/ab_preference")
    def ab_preference(req: Request):
        _require(req, Permission.CHAT_USE)
        body = req.json()
        comp_id = int(body["comparison_id"])
        comp = conversations.get_ab_comparison(comp_id)
        if comp is not None and comp.get("conversation_id") is not None:
            _check_ownership(req, comp["conversation_id"])
        conversations.record_ab_preference(comp_id, body["preference"])
        return {"ok": True}

    @app.get("/api/ab_pending")
    def ab_pending(req: Request):
        _require(req, Permission.CHAT_USE)
        return conversations.list_pending_ab(_uid(req))

    # ------------------------------------------------------------ permissions
    @app.get("/api/permissions")
    def get_permissions(req: Request):
        from archi_tpu_torch.utils.rbac.permissions import permissions_for_roles

        roles = req.context["identity"]["roles"]
        return {"roles": roles,
                "permissions": sorted(
                    p.value for p in permissions_for_roles(roles))}

    @app.post("/api/permissions/check")
    def check_permission(req: Request):
        perm = req.json().get("permission", "")
        roles = req.context["identity"]["roles"]
        try:
            allowed = has_permission(roles, Permission(perm))
        except ValueError:
            return error_response(f"unknown permission: {perm}", 400)
        return {"permission": perm, "allowed": allowed}

    # ------------------------------------------------------------------ auth
    # Session establishment (reference OAuth/SSO login flow,
    # app.py:2293-2459,2486-2572): password login + OAuth-shaped callback,
    # both issuing the signed session cookie the middleware honors.
    @app.post("/api/auth/login")
    def auth_login(req: Request):
        if session_service is None or user_service is None:
            return error_response("sessions not configured", 501)
        body = req.json()
        email = (body.get("email") or "").strip()
        if not email or not user_service.verify_password(
                email, body.get("password") or ""):
            return error_response("invalid credentials", 401)
        token = session_service.create(email)
        return Response(
            json.dumps({"ok": True, "email": email}), 200,
            "application/json",
            headers={"Set-Cookie": session_service.cookie_header(token)},
        )

    @app.get("/api/auth/callback")
    def auth_callback(req: Request):
        """OAuth-shaped: exchanges ?code= for an identity via the injected
        exchanger (a real IdP integration plugs in here)."""
        if session_service is None or oauth_exchange is None:
            return error_response("oauth not configured", 501)
        code = req.param("code")
        if not code:
            return error_response("missing code", 400)
        ident = oauth_exchange(code)
        if not ident or not ident.get("email"):
            return error_response("code exchange failed", 401)
        if user_service is not None:
            user_service.create_user(ident["email"],
                                     name=ident.get("name", ""))
        token = session_service.create(ident["email"])
        return Response(
            b"", 302, "text/plain",
            headers={"Location": "/",
                     "Set-Cookie": session_service.cookie_header(token)},
        )

    @app.post("/api/auth/logout")
    def auth_logout(req: Request):
        from archi_tpu_torch.utils.sessions import SessionService as _SS

        return Response(
            json.dumps({"ok": True}), 200, "application/json",
            headers={"Set-Cookie": _SS.clear_cookie_header()},
        )

    @app.get("/api/auth/session")
    def auth_session(req: Request):
        return req.context["identity"]

    @app.post("/api/auth/password")
    def auth_set_password(req: Request):
        """Set/update own password (admin may set others')."""
        if user_service is None:
            return error_response("users not configured", 501)
        body = req.json()
        me = req.context["identity"].get("email")
        target = body.get("email") or me
        if not me:
            return error_response("authentication required", 401)
        if target != me:
            _require(req, Permission.ADMIN_USERS)
        if not body.get("password"):
            raise ValueError("missing 'password'")
        user_service.set_password(target, body["password"])
        return {"ok": True}

    # ----------------------------------------------------------------- agents
    # Agents CRUD + template/save (reference app.py:2840-3111,
    # api.py:815,835).
    @app.get("/api/agents")
    def list_agents(req: Request):
        _require(req, Permission.AGENTS_USE)
        if agent_store is None:
            return []
        return [{"name": s.name, "description": s.description,
                 "tools": s.tools, "model": s.model}
                for s in agent_store.list()]

    @app.get("/api/agents/<name>")
    def get_agent(req: Request):
        _require(req, Permission.AGENTS_USE)
        if agent_store is None:
            return error_response("agents not configured", 501)
        spec = agent_store.get(req.path_params["name"])
        if spec is None:
            return error_response("agent not found", 404)
        return {"name": spec.name, "description": spec.description,
                "tools": spec.tools, "model": spec.model,
                "prompt": spec.prompt, "markdown": spec.to_markdown()}

    @app.post("/api/agents")
    def save_agent(req: Request):
        _require(req, Permission.AGENTS_MANAGE)
        if agent_store is None:
            return error_response("agents not configured", 501)
        from archi_tpu_torch.pipelines.agents.agent_spec import AgentSpec

        body = req.json()
        if not body.get("name") or not body.get("prompt"):
            raise ValueError("agent needs 'name' and 'prompt'")
        spec = AgentSpec(
            name=body["name"], description=body.get("description", ""),
            tools=body.get("tools") or [], prompt=body["prompt"],
            model=body.get("model"),
        )
        agent_store.save(spec)
        return {"ok": True, "name": spec.name}

    @app.delete("/api/agents/<name>")
    def delete_agent(req: Request):
        _require(req, Permission.AGENTS_MANAGE)
        if agent_store is None:
            return error_response("agents not configured", 501)
        return {"deleted": agent_store.delete(req.path_params["name"])}

    @app.put("/api/agents/active")
    def set_active_agent(req: Request):
        _require(req, Permission.AGENTS_MANAGE)
        if config_service is None or agent_store is None:
            return error_response("not configured", 501)
        name = req.json().get("name")
        if name and agent_store.get(name) is None:
            return error_response("agent not found", 404)
        email = req.context["identity"].get("email") or "anonymous"
        config_service.update_dynamic({"active_agent": name},
                                      changed_by=email)
        return {"ok": True, "active_agent": name}

    @app.get("/api/v2/agent/template")
    def agent_template(req: Request):
        _require(req, Permission.AGENTS_USE)
        from archi_tpu_torch.pipelines.agents.agent_spec import AgentStore

        return {"template": AgentStore.template()}

    @app.post("/api/v2/agent/save")
    def agent_save_markdown(req: Request):
        _require(req, Permission.AGENTS_MANAGE)
        if agent_store is None:
            return error_response("agents not configured", 501)
        spec = agent_store.save_markdown(req.json().get("markdown", ""))
        return {"ok": True, "name": spec.name}

    # ---------------------------------------------------------------- prompts
    # Prompt registry endpoints (reference api.py prompt management over
    # utils/prompt_service.py:34).
    @app.get("/api/v2/prompts")
    def list_prompts(req: Request):
        _require(req, Permission.CONFIG_READ)
        if prompt_service is None:
            return []
        return prompt_service.list_prompts()

    @app.get("/api/v2/prompts/<name>")
    def get_prompt(req: Request):
        _require(req, Permission.CONFIG_READ)
        if prompt_service is None:
            return error_response("prompts not configured", 501)
        content = prompt_service.get_prompt(req.path_params["name"])
        if content is None:
            return error_response("prompt not found", 404)
        return {"name": req.path_params["name"], "content": content}

    @app.put("/api/v2/prompts/<name>")
    def set_prompt(req: Request):
        _require(req, Permission.CONFIG_WRITE)
        if prompt_service is None:
            return error_response("prompts not configured", 501)
        content = req.json().get("content")
        if content is None:
            raise ValueError("missing 'content'")
        prompt_service.set_prompt(req.path_params["name"], content)
        return {"ok": True}

    @app.post("/api/v2/prompts/reload")
    def reload_prompts(req: Request):
        """Re-seed prompts from the deployment's prompt directory
        (reference api.py:982)."""
        _require(req, Permission.CONFIG_WRITE)
        if prompt_service is None or not prompts_dir:
            return error_response("prompt directory not configured", 501)
        n = prompt_service.seed_from_directory(prompts_dir, overwrite=True)
        return {"reloaded": n}

    @app.get("/api/v2/info")
    def v2_info(req: Request):
        import archi_tpu_torch

        return {"name": "archi-tpu-torch",
                "version": getattr(archi_tpu_torch, "__version__", "0.1"),
                "engine": "PyTorch/CUDA retrieval engine"}

    @app.get("/api/v2/health")
    def v2_health(req: Request):
        return {"status": "ok"}

    # ------------------------------------------------------------- providers
    @app.get("/api/providers")
    def providers(req: Request):
        _require(req, Permission.PROVIDERS_READ)
        from archi_tpu_torch.providers.registry import list_all_providers

        return list_all_providers()

    @app.get("/api/providers/models")
    def provider_models(req: Request):
        """Flat model listing across providers (reference app.py:2206)."""
        _require(req, Permission.PROVIDERS_READ)
        from archi_tpu_torch.providers.registry import list_all_providers

        out = []
        for p in list_all_providers():
            for m in p.get("models", []):
                out.append({"ref": f"{p['provider_type']}/{m['name']}",
                            **m, "provider": p["provider_type"],
                            "enabled": p.get("enabled", False)})
        return out

    @app.post("/api/providers/validate")
    def provider_validate(req: Request):
        """Key validation probe (reference app.py:2207): instantiate the
        provider with the supplied key and ask it for models."""
        _require(req, Permission.BYOK_MANAGE)
        body = req.json()
        name = body.get("provider", "")
        key = body.get("api_key") or ""
        try:
            from archi_tpu_torch.providers.registry import (
                get_chat_model_with_api_key, get_provider,
            )

            prov = get_provider(name)
            if not key.strip():
                raise ValueError("empty api key")
            models = prov.list_models()
            ref = f"{name}/{models[0].name}" if models else f"{name}/default"
            get_chat_model_with_api_key(ref, key)  # constructs the client
            return {"provider": name, "valid": True,
                    "models": len(models)}
        except Exception as e:
            return {"provider": name, "valid": False,
                    "error": f"{type(e).__name__}: {e}"}

    @app.get("/api/pipeline/default_model")
    def pipeline_default_model(req: Request):
        """Active pipeline's configured models (reference app.py:2211)."""
        cfg = config_service.get_full_config() if config_service else {}
        active = cfg.get("active_pipeline", "QAPipeline")
        models = (cfg.get("pipelines", {}).get(active, {}) or {}).get(
            "models", {})
        return {"pipeline": active, "models": models}

    @app.get("/api/agent/info")
    def agent_info(req: Request):
        """Active agent summary (reference app.py:2212)."""
        _require(req, Permission.AGENTS_USE)
        cfg = config_service.get_full_config() if config_service else {}
        name = cfg.get("active_agent")
        spec = agent_store.get(name) if (agent_store and name) else None
        return {
            "active_agent": name,
            "spec": None if spec is None else {
                "name": spec.name, "description": spec.description,
                "tools": spec.tools, "model": spec.model},
        }

    @app.post("/api/user/api_key")
    def set_api_key(req: Request):
        _require(req, Permission.BYOK_MANAGE)
        if byok_store is None:
            return error_response("BYOK not configured", 501)
        body = req.json()
        email = req.context["identity"].get("email") or "anonymous"
        byok_store.set_key(email, body["provider"], body["api_key"])
        return {"ok": True}

    @app.delete("/api/user/api_key/<provider>")
    def delete_api_key(req: Request):
        _require(req, Permission.BYOK_MANAGE)
        if byok_store is None:
            return error_response("BYOK not configured", 501)
        email = req.context["identity"].get("email") or "anonymous"
        return {"deleted": byok_store.delete_key(
            email, req.path_params["provider"])}

    @app.get("/api/user/api_keys")
    def list_api_keys(req: Request):
        _require(req, Permission.BYOK_MANAGE)
        if byok_store is None:
            return []
        email = req.context["identity"].get("email") or "anonymous"
        return byok_store.list_providers(email)

    # ------------------------------------------------------------- config v2
    @app.get("/api/v2/config")
    def get_config(req: Request):
        _require(req, Permission.CONFIG_READ)
        if config_service is None:
            return {}
        return config_service.get_full_config()

    @app.put("/api/v2/config")
    def update_config(req: Request):
        _require(req, Permission.CONFIG_WRITE)
        if config_service is None:
            return error_response("config service not configured", 501)
        email = req.context["identity"].get("email") or "anonymous"
        return config_service.update_dynamic(req.json(), changed_by=email)

    @app.get("/api/v2/config/static")
    def get_static_config(req: Request):
        _require(req, Permission.CONFIG_READ)
        return config_service.get_static() if config_service else {}

    @app.get("/api/v2/config/dynamic")
    def get_dynamic_config(req: Request):
        _require(req, Permission.CONFIG_READ)
        return config_service.get_dynamic() if config_service else {}

    @app.get("/api/v2/config/audit")
    def config_audit(req: Request):
        _require(req, Permission.CONFIG_READ)
        return config_service.audit_log() if config_service else []

    @app.get("/api/v2/config/effective")
    def effective_config(req: Request):
        _require(req, Permission.CONFIG_READ)
        if config_service is None:
            return {}
        prefs = {}
        if user_service and req.context["identity"].get("email"):
            prefs = user_service.get_preferences(
                req.context["identity"]["email"])
        return config_service.effective_config(prefs)

    # ------------------------------------------------------------------ users
    @app.get("/api/v2/users/me")
    def me(req: Request):
        return req.context["identity"]

    @app.put("/api/v2/users/preferences")
    def set_prefs(req: Request):
        email = req.context["identity"].get("email")
        if not email or user_service is None:
            return error_response("no identity", 401)
        for k, v in req.json().items():
            user_service.set_preference(email, k, v)
        return user_service.get_preferences(email)

    # -------------------------------------------------------------- analytics
    @app.get("/api/v2/analytics/models")
    def analytics_models(req: Request):
        _require(req, Permission.ANALYTICS_READ)
        return conversations.model_usage_stats()

    @app.get("/api/v2/analytics/ab")
    def analytics_ab(req: Request):
        _require(req, Permission.ANALYTICS_READ)
        return conversations.ab_stats()

    @app.get("/api/v2/analytics/feedback")
    def analytics_feedback(req: Request):
        _require(req, Permission.ANALYTICS_READ)
        return conversations.feedback_stats()

    @app.get("/api/v2/analytics/timing")
    def analytics_timing(req: Request):
        _require(req, Permission.ANALYTICS_READ)
        return conversations.timing_stats()

    # --------------------------------------------------------------- frontend
    @app.get("/")
    def index(req: Request):
        if frontend_html:
            return Response(frontend_html, 200, "text/html; charset=utf-8")
        return Response("<h1>archi-tpu chat service</h1>", 200,
                        "text/html; charset=utf-8")

    @app.get("/metrics")
    def metrics(req: Request):
        from archi_tpu_torch.utils.metrics import METRICS

        return Response(METRICS.render(), 200, "text/plain; version=0.0.4")

    @app.get("/healthz")
    def health(req: Request):
        return {"status": "ok", "service": "chat"}

    return app
