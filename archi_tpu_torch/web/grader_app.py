"""Grader service: student submissions → transcription → grading → approval.

Copy of ``archi_tpu/web/grader_app.py``.

Mirrors the reference's grader web app
(``src/interfaces/grader_app/app.py``, 840 LoC): students submit text or
images; images run through the ImageProcessingPipeline, the result through
the GradingPipeline; grades land in a PERSISTENT pending queue (app DB —
the reference persists in Postgres; round 1's in-memory dict lost state on
restart) that an admin approves, overrides, or rejects, with a decided-by
audit trail.
"""

from __future__ import annotations

import base64
import hmac

from archi_tpu_torch.utils.grader_service import GraderService
from archi_tpu_torch.web.framework import App, Request, error_response


def create_grader_app(*, grading_archi, image_archi=None,
                      grader_service=None, app_db=None,
                      roster=None, admin_password=None,
                      data_path=None, total_problems=None,
                      session_service=None) -> App:
    """JSON API; when ``roster`` + ``admin_password`` + ``data_path`` are
    configured, the student/admin HTML layer (``web/grader_ui.py``) is
    mounted on the same app and shares this queue."""
    app = App("grader")
    if grader_service is None:
        if app_db is None:
            from archi_tpu_torch.utils.app_db import AppDatabase

            app_db = AppDatabase(":memory:")
        grader_service = GraderService(app_db)
    svc = grader_service

    if roster is not None and admin_password and data_path:
        from archi_tpu_torch.web.grader_ui import GraderUI, add_grader_ui, \
            load_roster

        ui = GraderUI(
            grading_archi=grading_archi, image_archi=image_archi,
            grader_service=svc,
            roster=(load_roster(roster) if isinstance(roster, str)
                    else roster),
            admin_password=admin_password, data_path=data_path,
            total_problems=total_problems,
            session_service=session_service)
        add_grader_ui(app, ui)

    def _who(req: Request) -> str:
        return req.headers.get("x-user-email", "") or "anonymous"

    def _api_guard(req: Request):
        """When an admin password is configured (a student-facing
        deployment), the JSON API requires it in ``x-admin-password`` —
        otherwise any student could list everyone's grades or approve
        their own submission around the UI's gates.  Unconfigured
        deployments (internal tools, tests, RBAC'd reverse proxies)
        keep the open API."""
        if not admin_password:
            return None
        pw = req.headers.get("x-admin-password", "")
        if pw and hmac.compare_digest(pw, admin_password):
            return None
        return error_response("admin credentials required", 403)

    @app.post("/api/grade")
    def grade(req: Request):
        denied = _api_guard(req)
        if denied:
            return denied
        body = req.json()
        submission = body.get("submission", "")
        images = [base64.b64decode(b) for b in body.get("images_b64", [])]
        if images and image_archi is not None:
            transcription = image_archi.invoke(images=images).answer
            submission = (submission + "\n\n" + transcription).strip()
        if not submission:
            raise ValueError("empty submission")
        out = grading_archi.invoke(
            submission=submission,
            rubric=body.get("rubric", ""),
            max_points=body.get("max_points", 100),
        )
        sid = svc.add_submission(
            submission[:2000], out.answer,
            analysis=out.metadata.get("analysis"),
            summary=out.metadata.get("summary"),
            user_email=_who(req),
        )
        return {"submission_id": sid, "grade": out.answer,
                "status": "pending"}

    def _sid(req: Request):
        try:
            return int(req.path_params["sid"])
        except (KeyError, ValueError):
            return None

    @app.get("/api/submissions")
    def submissions(req: Request):
        denied = _api_guard(req)
        if denied:
            return denied
        return svc.list(status=req.param("status"))

    @app.get("/api/submissions/<sid>")
    def get_submission(req: Request):
        denied = _api_guard(req)
        if denied:
            return denied
        sid = _sid(req)
        sub = svc.get(sid) if sid is not None else None
        if sub is None:
            return error_response("not found", 404)
        return sub

    def _decide(req: Request, status: str):
        denied = _api_guard(req)
        if denied:
            return denied
        body = req.json()
        sid = _sid(req)
        sub = svc.decide(
            sid, status=status,
            final_grade=body.get("final_grade"), decided_by=_who(req),
        ) if sid is not None else None
        if sub is None:
            return error_response("not found", 404)
        # back-compat: 'grade' reflects the operative (possibly overridden)
        # grade in responses
        if sub.get("final_grade"):
            sub["grade"] = sub["final_grade"]
        return sub

    @app.post("/api/submissions/<sid>/approve")
    def approve(req: Request):
        return _decide(req, "approved")

    @app.post("/api/submissions/<sid>/reject")
    def reject(req: Request):
        return _decide(req, "rejected")

    @app.get("/healthz")
    def health(req: Request):
        return {"status": "ok", "service": "grader"}

    return app
