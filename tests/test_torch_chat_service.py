"""The port's chat service on the CPU, held against the JAX package's.

Both stacks serve one corpus with the same encoder weights (a local HF
snapshot at small widths: the port's ``TorchEmbedder`` on the CPU, the JAX
package's ``JaxEmbedder`` in f32 with XLA attention), an f32 flat index and
the reference's offline echo models.  Every request goes to both, in the
same order, so their databases hand out the same ids; each chat route
answers with the JAX service's JSON body once the clocks and the data
directories are taken out (scores within 1e-4).

The counterparts of ``tests/integration/test_services.py``'s chat tests
(round trip and history, SSE stream, feedback and analytics, BYOK, config,
error paths, stream cancellation, per-conversation document selection,
the admin DB console), of ``tests/integration/test_active_agent.py`` and of
``tests/unit/test_orchestrator.py``'s ``Archi`` contract; the data-manager
proxy over ``urllib``; remote mode (each chat over its own package's
data-manager) and the port's ``RemoteVectorStore`` against the JAX
data-manager; a rerank config over the port's store without
``attach_reranker``; the micro-batching config that starts the port's chat
in remote mode and raises ``AttributeError`` in the JAX package; and the
semantic fallback on an HTTP error.
"""

import copy
import dataclasses
import json
import urllib.error

import jax.numpy as jnp
import numpy as np
import pytest
import requests

from archi_tpu.bin.bootstrap import build_context as jax_build_context
from archi_tpu.bin.service_chat import build_app as jax_build_chat
from archi_tpu.bin.service_data_manager import build_app as jax_build_dm
from archi_tpu.engine.remote_vectorstore import \
    RemoteVectorStore as JaxRemoteVectorStore
from archi_tpu.engine.vectorstore import TpuVectorStore
from archi_tpu.models.bert import BertConfig as JaxConfig
from archi_tpu.models.bert import init_params
from archi_tpu.models.embedder import JaxEmbedder
from archi_tpu.models.tokenizer import WordPieceTokenizer as JaxTokenizer
from archi_tpu.models.train_encoder import save_model_dir
from archi_tpu.orchestrator.archi import Archi as JaxArchi
from archi_tpu.providers.chat_model import \
    ScriptedChatModel as JaxScriptedChatModel
from archi_tpu.utils.messages import Message as JaxMessage
from archi_tpu.utils.messages import ToolCall as JaxToolCall
from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.bin.service_chat import build_app as build_chat
from archi_tpu_torch.bin.service_data_manager import build_app as build_dm
from archi_tpu_torch.engine.reranker import MaxSimReranker, RerankingRetriever
from archi_tpu_torch.engine.remote_vectorstore import RemoteVectorStore
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.orchestrator.output import PipelineOutput
from archi_tpu_torch.providers.chat_model import ScriptedChatModel
from archi_tpu_torch.retrievers import HybridRetriever
from archi_tpu_torch.utils.messages import Message, ToolCall
from tests.test_torch_data_layer import WORDS
from tests.test_torch_data_layer import jax_cache_in_tmp  # noqa: F401
from tests.test_torch_data_layer import same_ranking

TOPICS = {
    "guide.md": "Submit jobs with the batch scheduler. The long queue allows "
                "jobs up to 48 hours.",
    "storage.md": "Storage quotas are 100GB per user on the shared "
                  "filesystem.",
    "gpu.md": "The gpu partition needs an account with an approved "
              "allocation.",
    "mail.md": "The mailing list archive is searchable by ticket number.",
}
QUESTIONS = ("how do I submit jobs?", "what is the storage quota?",
             "who may use the gpu partition", "zzzq unmatched words")
#: fields that carry a clock (the times of a chat's stages among them)
VOLATILE = {"timing", "created_at", "updated_at", "ts", "started_at",
            "finished_at", "completed_at", "elapsed_s", "last_login",
            "changed_at", "timestamp", "collected_at", "avg_s", "max_s"}
ALICE = {"X-User-Email": "alice@test"}
ADMIN = {"X-User-Email": "admin@test"}


def _corpus_and_model(tmp):
    """Four topic files and eight of random words; an encoder snapshot
    whose vocabulary covers them and the questions."""
    rng = np.random.default_rng(0)
    corpus = tmp / "corpus"
    corpus.mkdir()
    texts = []
    for name, text in TOPICS.items():
        texts.append(" ".join([text] * 3))
        (corpus / name).write_text(texts[-1])
    for i in range(8):
        texts.append(" ".join(rng.choice(WORDS, 30)))
        (corpus / f"notes{i}.md").write_text(texts[-1])
    cfg = JaxConfig(vocab_size=300, hidden_size=64, num_layers=2,
                    num_heads=2, intermediate_size=128,
                    max_position_embeddings=128)
    model = str(tmp / "model")
    save_model_dir(model, cfg, init_params(cfg, seed=5),
                   JaxTokenizer.build_vocab(texts + list(QUESTIONS),
                                            size=300))
    return corpus, model


def _dm_cfg(root, corpus, model, **extra):
    return {"embedding_name": "minilm", "model_dir": model,
            "embedding_kwargs": {"max_length": 128},
            "data_path": str(root / "data"),
            "db_path": str(root / "catalog.db"),
            "index": {"dtype": "float32"},
            "sources": {"local_files": {"paths": [str(corpus)]}}, **extra}


def _jax_store(model):
    return TpuVectorStore(JaxEmbedder(
        model_dir=model, compute_dtype=jnp.float32, attention_impl="xla",
        max_length=128), dtype=np.float32)


def _serve(app):
    return f"http://127.0.0.1:{app.serve('127.0.0.1', 0, background=True)}"


@dataclasses.dataclass
class Stack:
    ctx: object
    chat: str
    dm: str
    root: str


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    """(port, JAX, tmp, corpus, model): each package's context over the
    corpus (ingested), its data-manager app and its chat app (in-process,
    its proxy pointed at its own data-manager), served on localhost."""
    tmp = tmp_path_factory.mktemp("chat_svc")
    corpus, model = _corpus_and_model(tmp)
    port_ctx = build_context(
        overrides={"data_manager": _dm_cfg(tmp / "port", corpus, model)},
        device="cpu")
    jax_ctx = jax_build_context(
        overrides={"data_manager": _dm_cfg(tmp / "jax", corpus, model)},
        vectorstore=_jax_store(model))
    apps, out = [], []
    for ctx, dm_build, chat_build, sub in (
            (port_ctx, build_dm, build_chat, "port"),
            (jax_ctx, jax_build_dm, jax_build_chat, "jax")):
        assert ctx.data_manager.run_ingestion()["added"] == 12
        dm_app, _ = dm_build(ctx=ctx, initial_ingestion=False)
        dm_url = _serve(dm_app)
        ctx.config["services"]["chat"]["engine_url"] = dm_url
        chat_app, _ = chat_build(ctx=ctx)
        apps += [dm_app, chat_app]
        out.append(Stack(ctx, _serve(chat_app), dm_url, str(tmp / sub)))
        ctx.users.create_user("admin@test", roles=["admin"])
    yield out[0], out[1], tmp, corpus, model
    for app in apps:
        app.shutdown()
    for stack in out:
        stack.ctx.scheduler.stop()


# ------------------------------------------------------------- comparison
def _norm(body, root):
    """The body with the stack's data directory named ``<root>`` and the
    clock fields taken out."""
    def strip(v):
        if isinstance(v, dict):
            return {k: strip(x) for k, x in v.items() if k not in VOLATILE}
        if isinstance(v, list):
            return [strip(x) for x in v]
        return v

    return strip(json.loads(json.dumps(body).replace(root, "<root>")))


def assert_same(got, want, where="$"):
    """Equal JSON values, floats within 1e-4 (a rounding step of the
    4-decimal scores the wrapper reports)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), \
            (where, got, want)
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), \
            (where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)) and \
            abs(got - want) <= 1.0001e-4, (where, got, want)
    else:
        assert got == want, (where, got, want)


def both(stacks, method, path, *, json_body=None, headers=None, url="chat",
         expect=200):
    """One request to each stack's app → the port's (status, body), after
    checking that it equals the JAX stack's."""
    port, jax_stack = stacks[:2]
    got = []
    for stack in (port, jax_stack):
        r = requests.request(method, getattr(stack, url) + path,
                             json=json_body, headers=headers or {},
                             timeout=120)
        body = r.json() if r.content else None
        got.append((r.status_code, _norm(body, stack.root)))
    assert got[0][0] == got[1][0] == expect, (path, got)
    assert_same(got[0][1], got[1][1], path)
    return got[0][1]


def _sse(url, body, headers):
    r = requests.post(url + "/api/get_chat_response_stream", json=body,
                      headers=headers, stream=True, timeout=120)
    events = []
    for line in r.iter_lines():
        if line.startswith(b"data: "):
            if line[6:] == b"[DONE]":
                break
            events.append(json.loads(line[6:]))
    return events


# ------------------------------------------------------------------ tests
def test_health_and_info(stacks):
    assert both(stacks, "GET", "/healthz") == {"status": "ok",
                                                "service": "chat"}
    both(stacks, "GET", "/api/v2/health")
    port, jax_stack = stacks[:2]
    info = requests.get(port.chat + "/api/v2/info").json()
    assert info == {"name": "archi-tpu-torch", "version": "0.1.0",
                    "engine": "PyTorch/CUDA retrieval engine"}
    assert requests.get(jax_stack.chat + "/api/v2/info").json()["name"] == \
        "archi-tpu"


def test_chat_roundtrip_and_history(stacks):
    first = both(stacks, "POST", "/api/get_chat_response",
                 json_body={"message": QUESTIONS[0]}, headers=ALICE)
    assert first["answer"].startswith("ECHO:")
    assert first["sources"][0]["display_name"] == "guide.md"
    assert first["metadata"]["condensed_output"] == QUESTIONS[0]
    cid = first["conversation_id"]
    # a follow-up: the condense step runs over the history
    second = both(stacks, "POST", "/api/get_chat_response",
                  json_body={"message": "and storage quotas?",
                             "conversation_id": cid}, headers=ALICE)
    assert second["conversation_id"] == cid
    assert second["metadata"]["condensed_output"].startswith("ECHO:")
    msgs = both(stacks, "GET", f"/api/conversations/{cid}", headers=ALICE)
    assert len(msgs) == 4
    both(stacks, "GET", "/api/conversations", headers=ALICE)
    both(stacks, "PUT", f"/api/conversations/{cid}",
         json_body={"title": "jobs"}, headers=ALICE)
    both(stacks, "GET", f"/api/conversations/{cid}",
         headers={"X-User-Email": "mallory@test"}, expect=403)
    both(stacks, "GET", f"/api/tool_calls/{second['message_id']}",
         headers=ALICE)


@pytest.mark.parametrize("question", QUESTIONS)
def test_each_question_answers_as_the_jax_service(stacks, question):
    """The answer (the echo of the prompt with the retrieved chunks in
    rank order) and the sources."""
    body = both(stacks, "POST", "/api/get_chat_response",
                json_body={"message": question}, headers=ALICE)
    assert body["sources"]


def test_chat_stream_sse(stacks):
    port, jax_stack = stacks[:2]
    body = {"message": "what is the long queue limit?"}
    hdr = {"X-User-Email": "bob@test"}
    events = [_sse(s.chat, body, hdr) for s in (port, jax_stack)]
    assert_same(*[_norm(e, s.root) for e, s in zip(events, stacks[:2])])
    kinds = [e["type"] for e in events[0]]
    assert kinds[0] == "trace_start" and kinds[-1] == "final"
    assert "retrieval" in kinds
    final = events[0][-1]
    # the streamed answer is the chat's answer in a fresh conversation
    plain = both(stacks, "POST", "/api/get_chat_response", json_body=body,
                 headers=hdr)
    assert (final["answer"], final["sources"]) == \
        (plain["answer"], plain["sources"])
    trace = both(stacks, "GET", f"/api/trace/{final['trace_id']}",
                 headers=hdr)
    assert trace["status"] == "completed"
    both(stacks, "GET", f"/api/trace/message/{final['message_id']}",
         headers=hdr)


def test_feedback_and_analytics(stacks):
    hdr = {"X-User-Email": "carol@test"}
    r = both(stacks, "POST", "/api/get_chat_response",
             json_body={"message": "q"}, headers=hdr)
    fb = both(stacks, "POST", "/api/feedback",
              json_body={"message_id": r["message_id"], "rating": "like"},
              headers=hdr)
    assert fb["feedback_id"]
    both(stacks, "GET", "/api/v2/analytics/models", headers=hdr, expect=403)
    for stack in stacks[:2]:
        stack.ctx.users.set_roles("carol@test", ["user", "admin"])
    models = both(stacks, "GET", "/api/v2/analytics/models", headers=hdr)
    assert any(m["model_used"] == "echo" for m in models)
    for route in ("feedback", "ab", "timing"):
        both(stacks, "GET", f"/api/v2/analytics/{route}", headers=hdr)


def test_byok_endpoints(stacks):
    """``cryptography`` imports here: both services store the key."""
    hdr = {"X-User-Email": "dave@test"}
    assert stacks[0].ctx.byok_store is not None
    assert both(stacks, "POST", "/api/user/api_key",
                json_body={"provider": "openai", "api_key": "sk-dave"},
                headers=hdr) == {"ok": True}
    assert both(stacks, "GET", "/api/user/api_keys", headers=hdr) == \
        ["openai"]
    assert both(stacks, "DELETE", "/api/user/api_key/openai",
                headers=hdr) == {"deleted": True}


def test_config_endpoints(stacks):
    cfg = both(stacks, "GET", "/api/v2/config", headers=ADMIN)
    assert cfg["data_manager"]["embedding_name"] == "minilm"
    both(stacks, "PUT", "/api/v2/config", json_body={"chat.temperature": 0.3},
         headers=ADMIN)
    audit = both(stacks, "GET", "/api/v2/config/audit", headers=ADMIN)
    assert audit[0]["changes"]["chat.temperature"]["new"] == 0.3
    both(stacks, "PUT", "/api/v2/config",
         json_body={"data_manager.embedding_dimensions": 99}, headers=ADMIN,
         expect=400)
    for route in ("static", "dynamic", "effective"):
        both(stacks, "GET", f"/api/v2/config/{route}", headers=ADMIN)


@pytest.mark.parametrize("route", [
    "/api/providers", "/api/providers/models", "/api/pipeline/default_model",
    "/api/agent/info", "/api/permissions", "/api/v2/users/me",
    "/api/v2/prompts", "/api/agents", "/api/v2/agent/template",
    "/api/ab_pending", "/api/admin/db/tables"])
def test_read_routes_equal_the_jax_service(stacks, route):
    both(stacks, "GET", route, headers=ADMIN)


@pytest.mark.parametrize("case", [
    ("POST", "/api/get_chat_response", {}, {}, 400),
    ("GET", "/api/nope", None, {}, 404),
    ("GET", "/api/get_chat_response", None, {}, 405),
    ("POST", "/api/get_chat_response", {"message": "x"},
     {"X-Auth-Token": "garbage.token.here"}, 401),
    ("GET", "/api/trace/999999", None, ADMIN, 404),
    ("POST", "/api/permissions/check", {"permission": "bogus"}, ADMIN, 400),
], ids=["no_message", "unknown_route", "wrong_method", "bad_jwt",
        "no_trace", "unknown_permission"])
def test_error_paths(stacks, case):
    method, path, body, headers, code = case
    both(stacks, method, path, json_body=body, headers=headers, expect=code)


def test_stream_cancellation(stacks):
    tids = [stack.ctx.traces.create_trace() for stack in stacks[:2]]
    assert tids[0] == tids[1]
    assert both(stacks, "POST", "/api/cancel_stream",
                json_body={"trace_id": tids[0]}) == {"cancelled": True}
    for stack, tid in zip(stacks[:2], tids):
        assert stack.ctx.traces.get_trace(tid)["status"] == "cancelled"


def test_per_conversation_document_selection(stacks):
    hdr = {"X-User-Email": "sel@test"}
    r = both(stacks, "POST", "/api/get_chat_response",
             json_body={"message": QUESTIONS[0]}, headers=hdr)
    cid = r["conversation_id"]
    assert r["sources"][0]["display_name"] == "guide.md"
    docs = both(stacks, "GET", f"/api/conversations/{cid}/documents",
                headers=hdr)
    guide = next(d for d in docs if d["display_name"] == "guide.md")
    both(stacks, "PUT", f"/api/conversations/{cid}/documents",
         json_body={guide["resource_hash"]: False}, headers=hdr)
    r2 = both(stacks, "POST", "/api/get_chat_response",
              json_body={"message": QUESTIONS[0], "conversation_id": cid},
              headers=hdr)
    assert r2["sources"] and \
        all(s["display_name"] != "guide.md" for s in r2["sources"])
    r3 = both(stacks, "POST", "/api/get_chat_response",
              json_body={"message": QUESTIONS[0]}, headers=hdr)
    assert r3["sources"][0]["display_name"] == "guide.md"


def test_admin_db_console(stacks):
    rows = both(stacks, "POST", "/api/admin/db",
                json_body={"sql": "SELECT COUNT(*) AS n FROM messages"},
                headers=ADMIN)
    assert rows[0]["n"] > 0
    both(stacks, "POST", "/api/admin/db",
         json_body={"sql": "DELETE FROM messages"}, headers=ADMIN,
         expect=400)
    both(stacks, "POST", "/api/admin/db", json_body={"sql": "SELECT 1"},
         headers={"X-User-Email": "pleb@test"}, expect=403)


@pytest.mark.parametrize("route,upstream", [
    ("/api/dm/status", "/api/ingestion/status"),
    ("/api/dm/stats", "/api/stats"), ("/api/dm/grouped", "/api/data/grouped"),
    ("/api/dm/schedules", "/api/schedules")])
def test_dm_proxy_passes_the_data_manager_through(stacks, route, upstream):
    """The port's proxy goes over ``urllib``: the data-manager's own body,
    the JAX proxy's too."""
    port = stacks[0]
    body = both(stacks, "GET", route, headers=ADMIN)
    want = requests.get(port.dm + upstream, timeout=30).json()
    assert_same(body, _norm(want, port.root))


def test_dm_proxy_passes_an_error_status_through(stacks):
    """An error status of the data-manager comes back with its body (the
    JAX proxy's ``requests`` does not raise on it; ``urllib`` does, and
    the port's proxy catches it)."""
    body = both(stacks, "POST", "/api/dm/links", json_body={},
                headers=ADMIN, expect=400)
    assert "error" in body


def test_metrics_count_the_chats(stacks):
    port = stacks[0]

    def scrape():
        text = requests.get(port.chat + "/metrics", timeout=30).text
        return {line.split(" ")[0]: float(line.split(" ")[1])
                for line in text.splitlines()
                if line.startswith(("archi_chat_messages",
                                    "archi_chat_duration_seconds_count"))}

    before = scrape()
    for q in QUESTIONS[:3]:
        both(stacks, "POST", "/api/get_chat_response",
             json_body={"message": q}, headers=ALICE)
    after = scrape()
    assert {k: after[k] - before.get(k, 0.0) for k in after} == {
        "archi_chat_messages_total": 3.0,
        "archi_chat_duration_seconds_count": 3.0}


# ---------------------------------------------- the active agent (HTTP)
def test_activated_agent_drives_chat(stacks):
    spec = {"name": "fox-agent", "description": "fox specialist",
            "tools": ["retriever"],
            "prompt": "You are the fox specialist agent."}
    both(stacks, "POST", "/api/agents", json_body=spec, headers=ADMIN)
    both(stacks, "PUT", "/api/agents/active", json_body={"name": "fox-agent"},
         headers=ADMIN)
    try:
        r = both(stacks, "POST", "/api/get_chat_response",
                 json_body={"message": "and now?"}, headers=ADMIN)
        assert r["metadata"]["pipeline_used"] == "BaseReActAgent"
        info = both(stacks, "GET", "/api/agent/info", headers=ADMIN)
        assert info["active_agent"] == "fox-agent"
        both(stacks, "GET", "/api/agents/fox-agent", headers=ADMIN)
    finally:
        both(stacks, "PUT", "/api/agents/active", json_body={"name": None},
             headers=ADMIN)
    r = both(stacks, "POST", "/api/get_chat_response",
             json_body={"message": "back to normal?"}, headers=ADMIN)
    assert r["metadata"]["pipeline_used"] == "QAPipeline"


def test_scripted_agent_streams_tool_events(stacks, monkeypatch):
    """The activated agent, its model scripted to call the hybrid search
    once, streams the tool events; its sources equal the JAX agent's."""
    import archi_tpu.pipelines.agents.toolbox as jax_toolbox

    import archi_tpu_torch.pipelines.agents.toolbox as toolbox

    for module, model, msg, call in (
            (toolbox, ScriptedChatModel, Message, ToolCall),
            (jax_toolbox, JaxScriptedChatModel, JaxMessage, JaxToolCall)):
        def scripted(spec, config, *a, _build=module.agent_from_spec,
                     _model=model, _msg=msg, _call=call, **kw):
            agent = _build(spec, config, *a, **kw)
            agent.llms["agent_model"] = _model([
                _msg("assistant", "", tool_calls=[_call(
                    "search_vectorstore_hybrid", {"query": "batch jobs"},
                    "c1")]),
                _msg("assistant", "Use the batch scheduler."),
            ])
            return agent

        monkeypatch.setattr(module, "agent_from_spec", scripted)
    spec = {"name": "stream-agent", "tools": ["retriever"],
            "prompt": "Use the retriever tool, then answer."}
    both(stacks, "POST", "/api/agents", json_body=spec, headers=ADMIN)
    both(stacks, "PUT", "/api/agents/active",
         json_body={"name": "stream-agent"}, headers=ADMIN)
    try:
        events = [_norm(_sse(stack.chat, {"message": "jobs?"}, ADMIN),
                        stack.root) for stack in stacks[:2]]
    finally:
        both(stacks, "PUT", "/api/agents/active", json_body={"name": None},
             headers=ADMIN)
    assert_same(events[0], events[1])
    final = events[0][-1]
    assert final["metadata"]["pipeline_used"] == "BaseReActAgent"
    assert final["answer"] == "Use the batch scheduler."
    assert final["sources"][0]["display_name"] == "guide.md"
    kinds = {e.get("type") for e in events[0]}
    assert {"tool_start", "tool_result"} <= kinds


# ------------------------------------------------ the Archi contract
def _ranked(out):
    return [(d.metadata["chunk_id"], s) for d, s in zip(
        out.source_documents, out.metadata["retriever_scores"])]


@pytest.mark.parametrize("question", QUESTIONS)
def test_archi_qa_pipeline_matches_the_jax_stack(stacks, question):
    port, jax_stack = stacks[:2]
    out = Archi("QAPipeline", vectorstore=port.ctx.vectorstore).invoke(
        history=[("User", question)])
    want = JaxArchi("QAPipeline", vectorstore=jax_stack.ctx.vectorstore) \
        .invoke(history=[("User", question)])
    assert isinstance(out, PipelineOutput) and out.answer == want.answer
    assert out.metadata["pipeline_used"] == "QAPipeline"
    same_ranking(_ranked(out), _ranked(want))


def test_archi_unknown_pipeline_and_output_access():
    for archi in (Archi, JaxArchi):
        with pytest.raises(ValueError):
            archi("NopePipeline")
    out = PipelineOutput(answer="a", metadata={"x": 1})
    assert out["answer"] == "a" and out.get("metadata")["x"] == 1
    assert "answer" in set(iter(out))


def test_archi_grading_pipeline(stacks):
    kw = dict(submission="my essay about batch jobs", rubric="clarity",
              max_points=10)
    out = Archi("GradingPipeline", vectorstore=stacks[0].ctx.vectorstore) \
        .invoke(**kw)
    want = JaxArchi("GradingPipeline",
                    vectorstore=stacks[1].ctx.vectorstore).invoke(**kw)
    assert out.metadata["pipeline_used"] == "GradingPipeline"
    assert (out.answer, out.metadata) == (want.answer, want.metadata)


def test_agent_tool_loop_matches_the_jax_agent(stacks):
    """``Archi("BaseReActAgent")`` over each store, its model scripted to
    search once: the same events, tool calls and source documents."""
    outs = []
    for stack, archi, model, msg, call in (
            (stacks[0], Archi, ScriptedChatModel, Message, ToolCall),
            (stacks[1], JaxArchi, JaxScriptedChatModel, JaxMessage,
             JaxToolCall)):
        a = archi("BaseReActAgent", vectorstore=stack.ctx.vectorstore)
        a.pipeline.llms["agent_model"] = model([
            msg("assistant", "<think>search first</think>",
                tool_calls=[call("search_vectorstore_hybrid",
                                 {"query": "submit jobs"}, "call1")]),
            msg("assistant", "Use the batch scheduler."),
        ])
        outs.append(list(a.stream(history=[("User", "how to submit?")])))
    got, want = outs
    assert [e.metadata.get("event", {}).get("type") for e in got] == \
        [e.metadata.get("event", {}).get("type") for e in want]
    assert got[-1].final and got[-1].answer == "Use the batch scheduler."
    assert [d.page_content for d in got[-1].source_documents] == \
        [d.page_content for d in want[-1].source_documents]
    assert got[-1].source_documents
    calls = got[-1].extract_tool_calls()
    assert calls[0]["name"] == "search_vectorstore_hybrid"
    assert [c["name"] for c in calls] == \
        [c["name"] for c in want[-1].extract_tool_calls()]


# ------------------------------------------------------------ remote mode
@pytest.fixture(scope="module")
def remote(stacks):
    """Each package's chat in remote mode over its own data-manager: one
    config for both services (the port's with micro-batching on, which
    its bootstrap passes by for a remote store)."""
    port, jax_stack, tmp, corpus, model = stacks
    mb = {"serving": {"micro_batch": {"enabled": True}}}
    port_app, port_ctx = build_chat(overrides={
        "data_manager": _dm_cfg(tmp / "port_remote", corpus, model, **mb),
        "services": {"chat": {"engine_url": port.dm}}}, remote_engine=True)
    jax_app, jax_ctx = jax_build_chat(overrides={
        "data_manager": _dm_cfg(tmp / "jax_remote", corpus, model),
        "services": {"chat": {"engine_url": jax_stack.dm}}},
        remote_engine=True)
    yield (Stack(port_ctx, _serve(port_app), port.dm,
                 str(tmp / "port_remote")),
           Stack(jax_ctx, _serve(jax_app), jax_stack.dm,
                 str(tmp / "jax_remote")))
    for app, ctx in ((port_app, port_ctx), (jax_app, jax_ctx)):
        app.shutdown()
        ctx.scheduler.stop()


def test_remote_chat_is_built_over_the_remote_store(remote):
    ctx = remote[0].ctx
    assert type(ctx.vectorstore) is RemoteVectorStore
    assert ctx.vectorstore.base_url == remote[0].dm
    assert ctx.vectorstore.count() == 12


def test_remote_chats_agree(remote, stacks):
    """Each chat over its own package's data-manager, a conversation of
    every question in turn (the condense step over a history from the
    second on); the first answer equals the in-process chat's."""
    cid = None
    for i, question in enumerate(QUESTIONS):
        body = {"message": question}
        if cid is not None:
            body["conversation_id"] = cid
        r = both(remote, "POST", "/api/get_chat_response", json_body=body,
                 headers=ALICE)
        cid = r["conversation_id"]
        if i == 0:
            local = both(stacks, "POST", "/api/get_chat_response",
                         json_body=body, headers=ALICE)
            assert (r["answer"], r["sources"]) == \
                (local["answer"], local["sources"])
    both(remote, "GET", f"/api/conversations/{cid}", headers=ALICE)
    events = [_norm(_sse(s.chat, {"message": QUESTIONS[1]}, ALICE), s.root)
              for s in remote]
    assert_same(events[0], events[1])
    assert both(remote, "GET", "/api/dm/status", headers=ADMIN)["status"] == \
        "done"


@pytest.mark.parametrize("question", QUESTIONS)
def test_port_remote_store_against_the_jax_data_manager(stacks, question):
    """The port's ``RemoteVectorStore`` (``urllib``) and the JAX package's
    (``requests``) on the JAX data-manager: the same documents."""
    url = stacks[1].dm
    got, want = RemoteVectorStore(url), JaxRemoteVectorStore(url)
    assert got.count() == want.count() == 12

    def rows(results):
        return [(d.page_content, d.metadata, s) for d, s in results]

    assert rows(got.hybrid_search(question, k=5)) == \
        rows(want.hybrid_search(question, k=5))
    assert rows(got.similarity_search_with_score(question, k=3)) == \
        rows(want.similarity_search_with_score(question, k=3))
    first = want.hybrid_search(question, k=1)[0][0].metadata["resource_hash"]
    assert rows(got.hybrid_search(question, k=5, enabled_ids={first})) == \
        rows(want.hybrid_search(question, k=5, enabled_ids={first}))
    with pytest.raises(NotImplementedError):
        got.add_texts(["nope"])
    with pytest.raises(NotImplementedError):
        got.delete(["x"])


def test_micro_batching_config_raises_in_the_jax_package(stacks):
    """The departure: the JAX bootstrap calls ``enable_micro_batching`` on
    the remote store it was handed (the port's passes it by,
    ``remote``)."""
    port, jax_stack, tmp, corpus, model = stacks
    with pytest.raises(AttributeError, match="enable_micro_batching"):
        jax_build_chat(overrides={
            "data_manager": _dm_cfg(
                tmp / "jax_mb", corpus, model,
                serving={"micro_batch": {"enabled": True}}),
            "services": {"chat": {"engine_url": jax_stack.dm}}},
            remote_engine=True)


def test_http_error_reaches_the_semantic_fallback(stacks, remote,
                                                   monkeypatch):
    """The data-manager's hybrid route fails (500): the port's remote
    store raises ``urllib.error.HTTPError``, and ``HybridRetriever`` and
    the remote chat answer from the semantic route."""
    store = stacks[0].ctx.vectorstore

    def broken(*a, **kw):
        raise RuntimeError("hybrid route down")

    monkeypatch.setattr(store, "hybrid_search", broken)
    rs = RemoteVectorStore(stacks[0].dm)
    with pytest.raises(urllib.error.HTTPError) as err:
        rs.hybrid_search(QUESTIONS[0], k=3)
    assert err.value.code == 500
    semantic = rs.similarity_search_with_score(QUESTIONS[0], k=3)
    got = HybridRetriever(rs, k=3).invoke(QUESTIONS[0])
    assert [(d.page_content, s) for d, s in got] == \
        [(d.page_content, s) for d, s in semantic]
    r = requests.post(remote[0].chat + "/api/get_chat_response",
                      json={"message": QUESTIONS[0]}, headers=ALICE).json()
    assert [s["resource_hash"] for s in r["sources"]] == list(dict.fromkeys(
        d.metadata["resource_hash"] for d, _s in
        rs.similarity_search_with_score(QUESTIONS[0], k=5)))


def test_data_manager_token_is_sent(stacks, monkeypatch):
    """``DATA_MANAGER_TOKEN``: the remote store and the chat's proxy send
    it as ``x-data-token``; without it the gated data-manager answers
    401."""
    port, _jax, tmp, corpus, model = stacks
    monkeypatch.setenv("DATA_MANAGER_TOKEN", "tok")
    gated, _ = build_dm(ctx=port.ctx, initial_ingestion=False)
    url = _serve(gated)
    try:
        with pytest.raises(urllib.error.HTTPError) as err:
            RemoteVectorStore(url).count()
        assert err.value.code == 401
        assert RemoteVectorStore(url, auth_token="tok").count() == 12
        chat, ctx = build_chat(overrides={
            "data_manager": _dm_cfg(tmp / "port_token", corpus, model),
            "services": {"chat": {"engine_url": url}}}, remote_engine=True)
        curl = _serve(chat)
        r = requests.post(curl + "/api/get_chat_response",
                          json={"message": QUESTIONS[1]}, headers=ALICE)
        assert r.status_code == 200 and r.json()["sources"]
        assert requests.get(curl + "/api/dm/stats", headers=ADMIN) \
            .status_code == 200
        chat.shutdown()
        ctx.scheduler.stop()
    finally:
        gated.shutdown()


# ------------------------------------------------------------- the rerank
def _rerank_config(config):
    cfg = copy.deepcopy(config)
    cfg["data_manager"]["retrievers"] = {"hybrid_retriever": {
        "num_documents_to_retrieve": 3, "bm25_weight": 0.6,
        "semantic_weight": 0.4, "rerank": {"enabled": True, "overfetch": 8}}}
    return cfg


def test_rerank_config_reranks_over_the_port_store(stacks):
    """With ``rerank.enabled`` the port's pipeline wraps its retriever in
    the MaxSim rerank by itself (no ``attach_reranker``): the JAX stack's
    documents in its order, and the direct rerank's."""
    port, jax_stack = stacks[:2]
    got = Archi("QAPipeline", config=_rerank_config(port.ctx.config),
                vectorstore=port.ctx.vectorstore)
    want = JaxArchi("QAPipeline", config=_rerank_config(jax_stack.ctx.config),
                    vectorstore=jax_stack.ctx.vectorstore)
    store = port.ctx.vectorstore
    direct = RerankingRetriever(
        HybridRetriever(store, k=8), MaxSimReranker(store._embedding_function),
        k=3)
    for question in QUESTIONS:
        out = got.invoke(history=[("User", question)])
        ref = want.invoke(history=[("User", question)])
        assert type(got.pipeline.retriever) is RerankingRetriever
        assert len(out.source_documents) == 3
        assert [d.page_content for d in out.source_documents] == \
            [d.page_content for d in ref.source_documents], question
        np.testing.assert_allclose(out.metadata["retriever_scores"],
                                   ref.metadata["retriever_scores"],
                                   atol=1e-4)
        assert [(d.page_content, s) for d, s in direct.invoke(question)] == \
            [(d.page_content, s) for d, s in zip(
                out.source_documents, out.metadata["retriever_scores"])]


def test_rerank_chat_over_http(stacks):
    port, jax_stack = stacks[:2]
    apps, pair = [], []
    for stack, build in ((port, build_chat), (jax_stack, jax_build_chat)):
        ctx = dataclasses.replace(stack.ctx,
                                  config=_rerank_config(stack.ctx.config))
        app, _ = build(ctx=ctx)
        apps.append(app)
        pair.append(Stack(ctx, _serve(app), stack.dm, stack.root))
    try:
        for question in QUESTIONS[:2]:
            r = both(pair, "POST", "/api/get_chat_response",
                     json_body={"message": question}, headers=ALICE)
            assert 0 < len(r["sources"]) <= 3
    finally:
        for app in apps:
            app.shutdown()
