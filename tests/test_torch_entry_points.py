"""The port's other service entry points on the CPU, held against the JAX
package's.

Both packages' contexts serve one corpus with the same encoder weights (a
local HF snapshot at small widths, as in ``tests/test_torch_chat_service.py``:
the port's ``TorchEmbedder`` on the CPU, the JAX package's ``JaxEmbedder``
in f32 with XLA attention), an f32 flat index and the offline echo models.

- The grader (``bin/service_grader.build_app``): its JSON API and its
  student/admin web UI take the same requests in the same order on both
  stacks and answer the same (clocks and session tokens taken out); the
  grading pipeline retrieves the same documents; pending grades survive a
  restart; the reject flow (``tests/unit/test_grader_redmine_accounts.py``).
- ``service_create_account``: ``create_account`` and ``main``.
- The Mattermost and Piazza bots and the Redmine issue processor and mailer
  from the port's ``build_*`` with fake transports: the same posts, drafts,
  tickets and mails as the JAX package's services make.
- The SSO collector with a fake WebDriver, and ``js_lint`` over the port's
  frontend.
"""

import json
import re
import urllib.parse

import pytest

from archi_tpu.bin.bootstrap import build_context as jax_build_context
from archi_tpu.bin.service_create_account import \
    create_account as jax_create_account
from archi_tpu.bin.service_grader import build_app as jax_build_grader
from archi_tpu.orchestrator.archi import Archi as JaxArchi
from archi_tpu.web.bots import MattermostBot as JaxMattermostBot
from archi_tpu.web.bots import PiazzaBot as JaxPiazzaBot
from archi_tpu.web.framework import Request as JaxRequest
from archi_tpu.web.redmine_mailer import Mailbox as JaxMailbox
from archi_tpu.web.redmine_mailer import MailSender as JaxMailSender
from archi_tpu.web.redmine_mailer import RedmineIssueProcessor as JaxProcessor
from archi_tpu.web.redmine_mailer import RedmineMailer as JaxMailer
from archi_tpu_torch.bin import (service_create_account, service_mailbox,
                                 service_mattermost, service_piazza,
                                 service_redmine)
from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.bin.service_grader import build_app as build_grader
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.web.framework import Request
from archi_tpu_torch.web.redmine_mailer import Mailbox, MailSender
from tests.test_torch_chat_service import (QUESTIONS, _corpus_and_model,
                                           _dm_cfg, _jax_store)
from tests.test_torch_data_layer import jax_cache_in_tmp  # noqa: F401

ROSTER = {"alice@mit.edu": "c0de", "bob@mit.edu": "s3cret"}
ADMIN_PW = "adm1n-pw"
SUBMISSIONS = ("submit jobs with the batch scheduler, 48 hours at most",
               "storage quotas are 100GB per user",
               "the gpu partition needs an approved allocation",
               "zzzq an answer that matches nothing")
#: fields that carry a clock
VOLATILE = {"created_at", "decided_at", "updated_at"}


@pytest.fixture(scope="module")
def contexts(tmp_path_factory):
    """(port context, JAX context, tmp): each package's context over the
    same corpus, ingested, with its app database in a file."""
    tmp = tmp_path_factory.mktemp("entry_points")
    corpus, model = _corpus_and_model(tmp)
    port = build_context(overrides={
        "app_db": str(tmp / "port" / "app.db"),
        "data_manager": _dm_cfg(tmp / "port", corpus, model)}, device="cpu")
    jax_ctx = jax_build_context(overrides={
        "app_db": str(tmp / "jax" / "app.db"),
        "data_manager": _dm_cfg(tmp / "jax", corpus, model)},
        vectorstore=_jax_store(model))
    for ctx in (port, jax_ctx):
        assert ctx.data_manager.run_ingestion()["added"] == 12
    yield port, jax_ctx, tmp
    for ctx in (port, jax_ctx):
        ctx.scheduler.stop()


def _call(app, request_cls, method, path, *, body=None, form=None,
          headers=None):
    headers = dict(headers or {})
    if form is not None:
        body = urllib.parse.urlencode(form).encode()
        headers["content-type"] = "application/x-www-form-urlencoded"
    elif body is not None:
        body = json.dumps(body).encode()
    q = urllib.parse.urlparse(path)
    return app.router.dispatch(request_cls(
        method, q.path, urllib.parse.parse_qs(q.query), headers,
        body or b""))


def _norm(resp):
    """(status, body, Location) with clocks and session tokens taken out."""
    text = resp.body.decode() if isinstance(resp.body, bytes) else resp.body
    try:
        body = json.loads(text)
    except (TypeError, ValueError):
        body = re.sub(r"\d{4}-\d\d-\d\d[ T]\d\d:\d\d(:\d\d)?", "<time>",
                      text)
    else:
        def strip(v):
            if isinstance(v, dict):
                return {k: strip(x) for k, x in v.items()
                        if k not in VOLATILE}
            if isinstance(v, list):
                return [strip(x) for x in v]
            return v
        body = strip(body)
    return resp.status, body, resp.headers.get("Location")


class Both:
    """Sends each request to the port's app and the JAX package's, in the
    same order, and checks that they answer the same."""

    def __init__(self, port_app, jax_app):
        self.apps = ((port_app, Request), (jax_app, JaxRequest))
        self.cookies = [None, None]

    def __call__(self, method, path, expect=200, *, headers=None, **kw):
        got = []
        for i, (app, req_cls) in enumerate(self.apps):
            sent = dict(headers or {})
            if self.cookies[i]:
                sent["cookie"] = self.cookies[i]
            r = _call(app, req_cls, method, path, headers=sent, **kw)
            cookie = r.headers.get("Set-Cookie", "")
            m = re.search(r"archi_session=([^;]+)", cookie)
            if m:
                self.cookies[i] = f"archi_session={m.group(1)}"
            got.append(_norm(r))
        assert got[0] == got[1], (path, got)
        assert got[0][0] == expect, (path, got[0])
        return got[0][1]


def _grader_pair(contexts, **grader_cfg):
    port, jax_ctx, _ = contexts
    for ctx in (port, jax_ctx):
        ctx.config.setdefault("services", {})["grader"] = dict(grader_cfg)
    return Both(build_grader(ctx=port)[0], jax_build_grader(ctx=jax_ctx)[0])


# ------------------------------------------------------------------ grader
def test_grader_json_api_answers_as_the_jax_package(contexts):
    both = _grader_pair(contexts)
    sids = []
    for i, text in enumerate(SUBMISSIONS):
        body = both("POST", "/api/grade", headers={
            "x-user-email": f"stu{i}@x"}, body={
            "submission": text, "rubric": "physics", "max_points": 10})
        assert body["status"] == "pending" and body["grade"]
        sids.append(body["submission_id"])
    both("GET", "/api/submissions")
    both("GET", "/api/submissions?status=pending")
    both("POST", f"/api/submissions/{sids[0]}/approve",
         headers={"x-user-email": "prof@x"}, body={"final_grade": "10/10"})
    rj = both("POST", f"/api/submissions/{sids[1]}/reject", body={})
    assert rj["status"] == "rejected"
    got = both("GET", f"/api/submissions/{sids[0]}")
    assert got["status"] == "approved" and got["final_grade"] == "10/10"
    both("GET", "/api/submissions/99999", expect=404)
    both("POST", "/api/grade", expect=400, body={"submission": ""})
    both("GET", "/healthz")


def test_grading_retrieves_as_the_jax_package(contexts):
    port, jax_ctx, _ = contexts
    for text in SUBMISSIONS + QUESTIONS:
        outs = [cls("GradingPipeline", config=ctx.config,
                    vectorstore=ctx.vectorstore).invoke(
            submission=text, rubric="r", max_points=5)
            for cls, ctx in ((Archi, port), (JaxArchi, jax_ctx))]
        assert outs[0].answer == outs[1].answer
        assert outs[0].metadata == outs[1].metadata
        assert [(d.page_content, d.metadata["resource_hash"]) for d in
                outs[0].source_documents] == \
            [(d.page_content, d.metadata["resource_hash"])
             for d in outs[1].source_documents]
        assert len(outs[0].source_documents) == 3


def test_grader_state_survives_a_restart(contexts):
    """Pending grades live in the app database: a new app over the same
    database (the restart) lists them and decides them."""
    port, jax_ctx, _ = contexts
    both = Both(build_grader(ctx=port)[0], jax_build_grader(ctx=jax_ctx)[0])
    sid = both("POST", "/api/grade", headers={"x-user-email": "stu@x"},
               body={"submission": "F=ma", "rubric": "physics"})[
        "submission_id"]
    again = Both(build_grader(ctx=port)[0], jax_build_grader(ctx=jax_ctx)[0])
    subs = again("GET", "/api/submissions")
    assert any(s["id"] == sid and s["status"] == "pending" for s in subs)
    got = again("POST", f"/api/submissions/{sid}/approve",
                headers={"x-user-email": "prof@x"},
                body={"final_grade": "10/10"})
    assert (got["status"], got["grade"], got["decided_by"]) == \
        ("approved", "10/10", "prof@x")


def test_grader_ui_workflow_answers_as_the_jax_package(contexts, monkeypatch):
    """The student and admin pages: login, a submission, its review and
    grade, the one-attempt gate, the admin queue, an override, a reject and
    a reset, on both stacks."""
    _port, _jax, tmp = contexts
    data = tmp / "grader-data"
    data.mkdir()
    (data / "rubric_1.txt").write_text(
        "Problem 1: integrals\n---\naward 10 points for the right bound")
    (data / "rubric_2.txt").write_text("Problem 2: derivatives")
    roster = tmp / "roster.csv"
    roster.write_text("email,code\n" + "".join(
        f"{e},{c}\n" for e, c in ROSTER.items()))
    monkeypatch.setenv("GRADER_ADMIN_PASSWORD", ADMIN_PW)
    both = _grader_pair(contexts, roster_file=str(roster),
                        data_path=str(data))
    for path in ("/", "/problem/1"):
        both("GET", path, expect=303)
    both("POST", "/login", expect=303,
         form={"email": "eve@mit.edu", "code": "c0de"})
    assert both.cookies == [None, None]
    both("POST", "/login", expect=303,
         form={"email": "alice@mit.edu", "code": "c0de"})
    assert all(both.cookies)
    assert both("GET", "/").count("not submitted") == 2
    both("GET", "/problem/1")
    page = both("POST", "/problem/1",
                form={"submission": "the integral evaluates to pi/2"})
    assert "Review your submission" in page
    page = both("POST", "/problem/1/finalize", form={
        "approved_text": "the integral evaluates to pi/2",
        "additional_comments": "used substitution"})
    assert "your result" in page and "pending" in page
    both("POST", "/problem/1", expect=303, form={"submission": "again"})
    both("POST", "/admin", expect=303, form={"admin_password": "nope"})
    assert "Pending queue" in both("POST", "/admin",
                                   form={"admin_password": ADMIN_PW})
    sid = json.loads(_call(both.apps[0][0], Request, "GET",
                           "/api/submissions?status=pending", headers={
                               "x-admin-password": ADMIN_PW}).body)[-1]["id"]
    page = both("POST", f"/admin/submissions/{sid}/decide", form={
        "admin_password": ADMIN_PW, "action": "approve",
        "final_grade": "9/10 excellent bound handling"})
    assert f"Submission {sid} approved" in page
    assert "9 / 10" in both("GET", "/problem/1")
    both("POST", "/problem/2/finalize", form={"approved_text": "dy/dx = 2x"})
    sid2 = sid + 1
    assert "rejected" in both("POST", f"/admin/submissions/{sid2}/decide",
                              form={"admin_password": ADMIN_PW,
                                    "action": "reject"})
    assert "not accepted" in both("GET", "/problem/2")
    assert "1 attempt(s) removed" in both("POST", "/admin/reset", form={
        "admin_password": ADMIN_PW, "student_email": "alice@mit.edu",
        "problem": "2"})
    assert "submitForm" in both("GET", "/problem/2")
    both("GET", "/api/submissions", expect=403)


# ----------------------------------------------------------------- accounts
def test_create_account_matches_the_jax_package(contexts, tmp_path):
    port, jax_ctx, _ = contexts
    rows = []
    for fn, ctx in ((service_create_account.create_account, port),
                    (jax_create_account, jax_ctx)):
        fn(ctx.users, "carol@x", "pw-1", ["user", "admin"])
        assert ctx.users.verify_password("carol@x", "pw-1")
        assert not ctx.users.verify_password("carol@x", "pw-2")
        user = dict(ctx.users.get_user("carol@x"))
        rows.append({k: v for k, v in user.items()
                     if k not in ("created_at", "password_hash", "id")})
    assert rows[0] == rows[1]


def test_create_account_main_over_a_config(tmp_path, capsys):
    """``main`` with ``--email``: the account lands in the config's app
    database, where a new context verifies its password."""
    cfg = tmp_path / "c.yaml"
    cfg.write_text(f"""
app_db: {tmp_path}/app.db
data_manager:
  embedding_name: hash
  data_path: {tmp_path}/data
  db_path: {tmp_path}/catalog.db
""")
    service_create_account.main([str(cfg), "--email", "dave@x",
                                 "--password", "pw-3", "--roles",
                                 "user,admin"], device="cpu")
    assert "account created: dave@x roles=['user', 'admin']" in \
        capsys.readouterr().out
    ctx = build_context([str(cfg)], device="cpu")
    assert ctx.users.verify_password("dave@x", "pw-3")
    with pytest.raises(SystemExit):
        service_create_account.main([str(cfg), "--email", "x@x"],
                                    device="cpu")


# --------------------------------------------------------------------- bots
def _posts():
    return [{"id": f"p{i}", "question": q, "root_id": f"p{i}"}
            for i, q in enumerate(QUESTIONS + SUBMISSIONS)]


@pytest.mark.parametrize("kind", ["mattermost", "piazza"])
def test_bot_step_posts_as_the_jax_package(contexts, kind):
    port, jax_ctx, _ = contexts
    posted = [[], []]

    def transport(i):
        return dict(fetch_fn=_posts,
                    post_fn=lambda item, ans: posted[i].append(
                        (item["id"], ans)))

    if kind == "mattermost":
        bot, ctx = service_mattermost.build_bot(ctx=port, **transport(0))
        jax_bot = JaxMattermostBot(
            JaxArchi("QAPipeline", config=jax_ctx.config,
                     vectorstore=jax_ctx.vectorstore), **transport(1))
    else:
        bot, ctx = service_piazza.build_bot(ctx=port, **transport(0))
        jax_bot = JaxPiazzaBot(
            JaxArchi("QAPipeline", config=jax_ctx.config,
                     vectorstore=jax_ctx.vectorstore), network_id="",
            **transport(1))
    assert ctx is port
    assert bot.step() == jax_bot.step() == len(_posts())
    assert bot.step() == jax_bot.step() == 0     # answered once
    assert posted[0] == posted[1]
    assert all(ans.startswith("ECHO:") for _id, ans in posted[0])


class FakeRedmine:
    def __init__(self):
        self.issues, self.notes = [], []

    def create_issue(self, project, subject, desc):
        self.issues.append((project, subject, desc))
        return {"id": 40 + len(self.issues)}

    def add_note(self, issue_id, note, private=False):
        self.notes.append((issue_id, note, private))


class FakeSender:
    def __init__(self):
        self.sent = []

    def send(self, to, subject, body):
        self.sent.append((to, subject, body))


ISSUES = {
    "open": [{"id": i + 1, "subject": q, "description": f"details {i}"}
             for i, q in enumerate(QUESTIONS)],
    "resolved": [{"id": 9, "subject": "quota", "author": {"mail": "u@x"},
                  "journals": [{"notes": "raised to 200GB"}]}],
}


def test_redmine_processor_drafts_as_the_jax_package(contexts):
    port, jax_ctx, _ = contexts
    fakes = [(FakeRedmine(), FakeSender()) for _ in range(2)]
    proc, ctx = service_redmine.build_processor(
        ctx=port, list_issues=ISSUES.get, redmine_client=fakes[0][0],
        sender=fakes[0][1])
    jax_proc = JaxProcessor(
        list_issues=ISSUES.get, redmine_client=fakes[1][0],
        agent_archi=JaxArchi("CMSCompOpsAgent", config=jax_ctx.config,
                             vectorstore=jax_ctx.vectorstore),
        sender=fakes[1][1], project_id="support")
    assert ctx is port and proc.project_id == "support"
    assert proc.step() == jax_proc.step() == len(QUESTIONS) + 1
    assert proc.step() == jax_proc.step() == 0
    assert [(r.notes, s.sent) for r, s in fakes[:1]] == \
        [(r.notes, s.sent) for r, s in fakes[1:]]
    assert len(fakes[0][0].notes) == len(QUESTIONS)
    assert fakes[0][1].sent == [("u@x", "Re: quota [#9] resolved",
                                 "raised to 200GB")]


def test_redmine_mailer_tickets_as_the_jax_package(contexts):
    port, jax_ctx, _ = contexts
    mails = [{"uid": str(i), "from": f"user{i}@x", "subject": q,
              "body": f"body {i}"} for i, q in enumerate(QUESTIONS)]
    fakes = [(FakeRedmine(), FakeSender()) for _ in range(2)]
    mailer, _ = service_mailbox.build_mailer(
        ctx=port, mailbox=Mailbox("", "", "", fetch_fn=lambda: mails),
        sender=MailSender("", send_fn=lambda to, subj, body:
                          fakes[0][1].send(to, subj, body)),
        redmine_client=fakes[0][0])
    jax_mailer = JaxMailer(
        mailbox=JaxMailbox("", "", "", fetch_fn=lambda: mails),
        sender=JaxMailSender("", send_fn=lambda to, subj, body:
                             fakes[1][1].send(to, subj, body)),
        redmine_client=fakes[1][0],
        agent_archi=JaxArchi("CMSCompOpsAgent", config=jax_ctx.config,
                             vectorstore=jax_ctx.vectorstore))
    assert mailer.step() == jax_mailer.step() == len(QUESTIONS)
    assert mailer.step() == jax_mailer.step() == 0
    for got, want in zip(fakes[0], fakes[1]):
        assert vars(got) == vars(want)
    assert len(fakes[0][0].issues) == len(QUESTIONS)


# ---------------------------------------------------------- sso, js_lint
class FakeElement:
    def __init__(self, href=None):
        self._href = href
        self.typed = []
        self.clicked = False

    def get_attribute(self, name):
        return self._href

    def send_keys(self, text):
        self.typed.append(text)

    def click(self):
        self.clicked = True


class FakeDriver:
    """The WebDriver surface ``BrowserSSOScraper`` uses
    (``tests/unit/test_sso_browser.py``)."""

    def __init__(self, pages):
        self.pages = pages
        self.url = None
        self.visited = []
        self.quit_called = False
        self.login_elements = {
            "input[name=username]": FakeElement(),
            "input[name=password]": FakeElement(),
            "button[type=submit]": FakeElement(),
        }

    def get(self, url):
        self.url = url
        self.visited.append(url)

    @property
    def page_source(self):
        return self.pages.get(self.url, ("<html>404</html>", []))[0]

    def find_elements(self, by, selector):
        if selector in self.login_elements:
            return [self.login_elements[selector]]
        return [FakeElement(href=u) for u in
                self.pages.get(self.url, ("", []))[1]]

    def quit(self):
        self.quit_called = True


def test_sso_crawl_matches_the_jax_package(tmp_path):
    from archi_tpu.data.catalog import CatalogService as JaxCatalog
    from archi_tpu.data.collectors import sso as jax_sso
    from archi_tpu.data.persistence import \
        PersistenceService as JaxPersistence
    from archi_tpu_torch.data.catalog import CatalogService
    from archi_tpu_torch.data.collectors import sso
    from archi_tpu_torch.data.persistence import PersistenceService

    pages = {"https://docs.x/": ("<html>root</html>", [
        "https://docs.x/a", "https://docs.x/b", "https://other.host/evil",
        "https://docs.x/logo.png"]),
        "https://docs.x/a": ("<html>page a</html>", ["https://docs.x/"]),
        "https://docs.x/b": ("<html>page b</html>", ["https://docs.x/c"]),
        "https://docs.x/c": ("<html>page c</html>", [])}
    out = []
    for name, mod, cat_cls, pers_cls in (
            ("port", sso, CatalogService, PersistenceService),
            ("jax", jax_sso, JaxCatalog, JaxPersistence)):
        (tmp_path / name).mkdir()
        pers = pers_cls(str(tmp_path / name / "data"),
                        cat_cls(str(tmp_path / name / "cat.db")))
        driver = FakeDriver(pages)
        scraper = mod.BrowserSSOScraper(
            pers, driver_factory=lambda: driver, max_depth=2, wait_time=0,
            login=mod.form_login("alice", "pw123", wait=0))
        hashes = scraper.crawl("https://docs.x/")
        docs = sorted((d["url"], d["source_type"], d["resource_hash"])
                      for d in pers.catalog.list_documents())
        out.append((sorted(hashes), docs, driver.visited, driver.quit_called,
                    [e.typed for e in driver.login_elements.values()]))
        assert not mod.selenium_available()
        with pytest.raises(ImportError):
            mod.BrowserSSOScraper(None)
    assert out[0] == out[1]
    assert len(out[0][0]) == 4 and out[0][4][:2] == [["alice"], ["pw123"]]


def test_js_lint_passes_the_ports_frontend():
    from archi_tpu.web.frontend import FRONTEND_HTML as JAX_HTML
    from archi_tpu.web.js_lint import lint_html as jax_lint
    from archi_tpu_torch.web.frontend import FRONTEND_HTML
    from archi_tpu_torch.web.js_lint import JsLexError, check_balance, lex, \
        lint_html

    stats = lint_html(FRONTEND_HTML)
    assert stats == jax_lint(JAX_HTML)
    assert stats["scripts"] >= 1 and stats["tokens"] > 2000
    assert stats["functions"] > 20 and stats["api_paths"]
    with pytest.raises(JsLexError):
        check_balance(lex("function f() { return 1; "))
