"""Grader service entry point: grade students' submissions over the port's
store.

Counterpart of ``archi_tpu/bin/service_grader.py`` (reference
``src/bin/service_grader.py``), over the port's ``build_context``: the
``GradingPipeline`` and ``ImageProcessingPipeline`` run over the port's
store, on the card unless the caller passes ``device="cpu"``::

    python -m archi_tpu_torch.bin.service_grader config.yaml

(a YAML config needs PyYAML; ``build_app(overrides=...)`` takes the same
settings as a dict).  ``GRADER_ADMIN_PASSWORD`` (or its ``*_FILE``) gates
the admin pages of the web UI.
"""

from __future__ import annotations

import sys

from archi_tpu_torch.bin.bootstrap import build_context
from archi_tpu_torch.orchestrator.archi import Archi
from archi_tpu_torch.web.grader_app import create_grader_app


def build_app(config_paths=(), overrides=None, ctx=None, *, device=None,
              devices=None):
    ctx = ctx or build_context(config_paths, overrides, device=device,
                               devices=devices)
    grading = Archi("GradingPipeline", config=ctx.config,
                    vectorstore=ctx.vectorstore)
    image = Archi("ImageProcessingPipeline", config=ctx.config,
                  vectorstore=ctx.vectorstore)
    # student/admin web UI mounts when its config is present (reference
    # serves the full grader web app; JSON API alone otherwise)
    from archi_tpu_torch.providers.base import read_secret

    svc_cfg = ctx.config.get("services", {}).get("grader", {})
    return create_grader_app(
        grading_archi=grading, image_archi=image, app_db=ctx.app_db,
        roster=svc_cfg.get("roster_file"),
        admin_password=read_secret("GRADER_ADMIN_PASSWORD"),
        data_path=svc_cfg.get("data_path"),
        total_problems=svc_cfg.get("total_problems")), ctx


def main() -> None:
    app, ctx = build_app(sys.argv[1:])
    svc = ctx.config["services"]["grader"]
    print(f"grader service on {svc.get('host', '0.0.0.0')}:{svc['port']}")
    app.serve(svc.get("host", "0.0.0.0"), svc["port"])


if __name__ == "__main__":
    main()
