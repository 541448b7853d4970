"""Secrets + volume staging for deployments.

Copy of ``archi_tpu/cli/managers.py``.

The reference splits deployment preparation across
``src/cli/managers/secrets_manager.py`` (.env loading, required-secret
derivation from enabled services/sources/models, validation, *_FILE
staging) and ``volume_manager.py`` (named-volume creation + local-file
staging) plus Grafana asset staging (``templates_manager.py:335``).
These are their TPU-host equivalents: secrets stage as 0600 ``*_FILE``
files read by ``utils/env.read_secret``-style lookups, and "volumes"
are per-deployment data directories (the compose artifact still gets
named volumes for containerized installs).
"""

from __future__ import annotations

import os
import shutil
from typing import Iterable, Optional

from archi_tpu_torch.cli.registry import SERVICES

# provider name → API-key secret (reference _get_model_based_secrets)
_PROVIDER_SECRETS = {
    "openai": "OPENAI_API_KEY",
    "anthropic": "ANTHROPIC_API_KEY",
    "gemini": "GEMINI_API_KEY",
    "openrouter": "OPENROUTER_API_KEY",
}
# source type → secret names (reference get_required_secrets_for_sources)
_SOURCE_SECRETS = {
    "jira": ("JIRA_TOKEN",),
    "redmine": ("REDMINE_API_KEY",),
    "sso": ("SSO_USER", "SSO_PASSWORD"),
}


def parse_env_file(path: str) -> dict[str, str]:
    """Minimal .env parser (python-dotenv is not in this image):
    KEY=VALUE lines, '#' comments, optional single/double quotes,
    blank values dropped."""
    out: dict[str, str] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, val = line.partition("=")
            key = key.strip()
            if key.startswith("export "):
                key = key[len("export "):].strip()
            val = val.strip()
            if len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
                val = val[1:-1]
            if key and val:
                out[key] = val
    return out


class SecretsManager:
    """Load a .env file, derive the secrets a deployment needs, validate
    presence, and stage them as per-secret files."""

    def __init__(self, env_file_path: Optional[str] = None):
        self.env_file_path = env_file_path
        self.secrets = parse_env_file(env_file_path) if env_file_path else {}

    # ------------------------------------------------------------ derive
    def required_for(self, config: dict) -> set[str]:
        required: set[str] = set()
        services = config.get("services", {})
        for name, svc in services.items():
            if isinstance(svc, dict) and svc.get("enabled"):
                sdef = SERVICES.get(name)
                if sdef:
                    required.update(sdef.required_secrets)
        for src in (config.get("data_manager", {})
                    .get("sources", {}) or {}):
            required.update(_SOURCE_SECRETS.get(src, ()))
        # Provider keys are required only for providers a configured
        # pipeline model actually references ("openai/gpt-4o" →
        # OPENAI_API_KEY) — defaults enable every provider as *available
        # when a key exists*, which must not hard-fail keyless deploys
        # (reference _get_model_based_secrets derives from models, not
        # from the provider list).
        for pcfg in (config.get("pipelines", {}) or {}).values():
            if not isinstance(pcfg, dict):
                continue
            for ref in (pcfg.get("models", {}) or {}).values():
                prov = str(ref).split("/", 1)[0]
                if prov in _PROVIDER_SECRETS:
                    required.add(_PROVIDER_SECRETS[prov])
        return required

    def validate(self, required: Iterable[str]) -> None:
        """Missing required secrets are a hard deploy error (reference
        validate_secrets:107) — env vars count as present."""
        missing = [s for s in sorted(set(required))
                   if s not in self.secrets and not os.environ.get(s)]
        if missing:
            raise ValueError(
                f"missing required secrets: {', '.join(missing)} "
                f"(add them to {self.env_file_path or 'a .env file'} "
                f"or the environment)")

    def get(self, key: str) -> Optional[str]:
        return self.secrets.get(key) or os.environ.get(key) or None

    # ------------------------------------------------------------- stage
    def stage(self, target_dir: str, required: Iterable[str]) -> list[str]:
        """Write each secret to ``<target_dir>/<NAME>`` (0600) and return
        staged names — services consume them via ``<NAME>_FILE``
        convention (reference write_secrets_to_files:133)."""
        os.makedirs(target_dir, exist_ok=True)
        os.chmod(target_dir, 0o700)
        staged = []
        for name in sorted(set(required)):
            val = self.get(name)
            if val is None:
                continue
            path = os.path.join(target_dir, name)
            fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
            with os.fdopen(fd, "w") as f:
                f.write(val)
            staged.append(name)
        return staged

    def env_for_services(self, secrets_dir: str,
                         staged: Iterable[str]) -> dict[str, str]:
        """Environment overlay pointing services at the staged files."""
        return {f"{name}_FILE": os.path.join(secrets_dir, name)
                for name in staged}


class VolumeManager:
    """Per-deployment data directories (the TPU-host analog of named
    Docker volumes) + local-file staging into the data volume."""

    #: directories every deployment gets (reference get_required_volumes)
    REQUIRED = ("data", "secrets", "grafana")

    def __init__(self, deployment_dir: str):
        self.deployment_dir = deployment_dir

    def path(self, volume: str) -> str:
        return os.path.join(self.deployment_dir, volume)

    def create_required(self) -> list[str]:
        created = []
        for vol in self.REQUIRED:
            p = self.path(vol)
            if not os.path.isdir(p):
                os.makedirs(p, exist_ok=True)
                created.append(vol)
        return created

    def stage_local_files(self, config: dict) -> list[str]:
        """Copy configured local_files sources into the data volume so
        the running services see a stable snapshot (reference
        local_file_stager; uploads land next to them at runtime)."""
        staged = []
        paths = ((config.get("data_manager", {}).get("sources", {}) or {})
                 .get("local_files", {}) or {}).get("paths", [])
        target = os.path.join(self.path("data"), "staged")
        for src in paths:
            if not os.path.exists(src):
                continue
            dst = os.path.join(target, os.path.basename(src.rstrip("/")))
            if os.path.isdir(src):
                shutil.copytree(src, dst, dirs_exist_ok=True)
            else:
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                shutil.copy2(src, dst)
            staged.append(dst)
        return staged

    def stage_grafana(self) -> list[str]:
        """Stage the Grafana provisioning assets (dashboard JSON +
        datasource yaml) into the grafana volume (reference
        templates_manager.py:335)."""
        import json

        assets = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "assets")
        dash_src = os.path.join(assets, "grafana_dashboard.json")
        out = []
        gdir = self.path("grafana")
        os.makedirs(os.path.join(gdir, "dashboards"), exist_ok=True)
        os.makedirs(os.path.join(gdir, "datasources"), exist_ok=True)
        if os.path.exists(dash_src):
            dst = os.path.join(gdir, "dashboards", "archi-tpu.json")
            shutil.copy2(dash_src, dst)
            out.append(dst)
        ds = os.path.join(gdir, "datasources", "archi.yaml")
        with open(ds, "w") as f:
            f.write(
                "apiVersion: 1\n"
                "datasources:\n"
                "  - name: archi-tpu-metrics\n"
                "    type: prometheus\n"
                "    access: proxy\n"
                "    url: http://data_manager:7862/metrics\n")
        out.append(ds)
        # provisioning index so a grafana container mounts gdir directly
        prov = os.path.join(gdir, "provisioning.json")
        with open(prov, "w") as f:
            json.dump({"dashboards": "dashboards/",
                       "datasources": "datasources/"}, f)
        out.append(prov)
        return out

    def remove(self) -> None:
        for vol in self.REQUIRED:
            p = self.path(vol)
            if os.path.isdir(p):
                shutil.rmtree(p)
