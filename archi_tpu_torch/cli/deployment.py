"""Deployment manager: local process supervision + compose rendering.

Copy of ``archi_tpu/cli/deployment.py``.

The reference deploys Docker/Podman fleets
(``src/cli/managers/deployment_manager.py:21`` compose up/down/restart;
``templates_manager.py:438`` renders the compose file).  On a TPU host the
services run as supervised local processes (one per enabled service, PIDs
tracked per deployment), and a docker-compose manifest is still rendered as
a deployment artifact for containerized installs.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from typing import Optional

import yaml

from archi_tpu_torch.cli.registry import SERVICES, resolve_dependencies

DEPLOY_ROOT = os.environ.get(
    "ARCHI_TPU_DEPLOYMENTS",
    os.path.join(os.path.expanduser("~"), ".archi_tpu", "deployments"),
)


def deployment_dir(name: str) -> str:
    return os.path.join(DEPLOY_ROOT, name)


def render_compose(config: dict) -> str:
    """docker-compose manifest for containerized installs (parity artifact
    with reference base-compose.yaml rendering)."""
    services = {}
    for name, svc_cfg in config.get("services", {}).items():
        if not isinstance(svc_cfg, dict) or not svc_cfg.get("enabled"):
            continue
        sdef = SERVICES.get(name)
        if sdef is None:
            continue
        entry = {
            "image": "archi-tpu:latest",
            "command": ["python", "-m", sdef.module, "/config/config.yaml"],
            "restart": "always",
            "volumes": ["./config.yaml:/config/config.yaml:ro",
                        "archi-data:/data"],
            "environment": {"VERBOSITY": str(config.get("verbosity", 3))},
        }
        port = svc_cfg.get("port")
        if port:
            entry["ports"] = [f"{port}:{port}"]
        if sdef.depends_on:
            entry["depends_on"] = [d for d in sdef.depends_on
                                   if config["services"].get(d, {}).get("enabled")]
        services[name] = entry
    return yaml.safe_dump(
        {"services": services, "volumes": {"archi-data": {}}},
        sort_keys=False,
    )


class DeploymentManager:
    def __init__(self, name: str):
        self.name = name
        self.dir = deployment_dir(name)
        self.state_file = os.path.join(self.dir, "state.json")

    # ------------------------------------------------------------------ state
    def _load_state(self) -> dict:
        if os.path.exists(self.state_file):
            with open(self.state_file) as f:
                return json.load(f)
        return {"services": {}}

    def _save_state(self, state: dict) -> None:
        os.makedirs(self.dir, exist_ok=True)
        with open(self.state_file, "w") as f:
            json.dump(state, f, indent=2)

    def exists(self) -> bool:
        return os.path.isdir(self.dir)

    # ------------------------------------------------------------------ start
    def prepare(self, config: dict,
                env_file: Optional[str] = None) -> dict[str, str]:
        """Stage config, volumes, Grafana assets, and secrets; returns
        the ``*_FILE`` environment overlay for started services
        (reference SecretsManager/VolumeManager/TemplateManager
        preparation, ``cli_main.py:43-173``)."""
        from archi_tpu_torch.cli.managers import SecretsManager, VolumeManager

        os.makedirs(self.dir, exist_ok=True)
        volumes = VolumeManager(self.dir)
        volumes.create_required()
        volumes.stage_grafana()
        cfg = dict(config)
        dm = dict(cfg.get("data_manager", {}))
        dm.setdefault("data_path", os.path.join(self.dir, "data"))
        dm["db_path"] = dm.get("db_path") or os.path.join(
            self.dir, "data", "catalog.db")
        cfg["data_manager"] = dm
        with open(os.path.join(self.dir, "config.yaml"), "w") as f:
            yaml.safe_dump(cfg, f, sort_keys=False)
        with open(os.path.join(self.dir, "compose.yaml"), "w") as f:
            f.write(render_compose(cfg))
        secrets = SecretsManager(env_file)
        required = secrets.required_for(cfg)
        secrets.validate(required)
        staged = secrets.stage(volumes.path("secrets"), required)
        return secrets.env_for_services(volumes.path("secrets"), staged)

    def start(self, config: dict, *, only: Optional[list[str]] = None,
              env_file: Optional[str] = None) -> dict:
        secret_env = self.prepare(config, env_file=env_file)
        enabled = [n for n, c in config.get("services", {}).items()
                   if isinstance(c, dict) and c.get("enabled")]
        if only:
            enabled = [n for n in enabled if n in only]
        order = resolve_dependencies(enabled)
        state = self._load_state()
        started = {}
        for name in order:
            sdef = SERVICES.get(name)
            if sdef is None or name == "benchmarking":
                continue
            if self._alive(state["services"].get(name, {}).get("pid")):
                started[name] = state["services"][name]
                continue
            log = open(os.path.join(self.dir, f"{name}.log"), "a")
            # Services run with cwd = the deployment dir; ``-m`` resolves
            # archi_tpu from sys.path, so the package root (wherever THIS
            # module was imported from) must ride PYTHONPATH — the parent's
            # environment cannot be relied on to carry it.
            pkg_root = os.path.dirname(os.path.dirname(
                os.path.dirname(os.path.abspath(__file__))))
            child_env = {**os.environ, **secret_env}
            child_env["PYTHONPATH"] = (
                pkg_root + os.pathsep + child_env.get("PYTHONPATH", ""))
            proc = subprocess.Popen(
                [sys.executable, "-m", sdef.module,
                 os.path.join(self.dir, "config.yaml")],
                stdout=log, stderr=subprocess.STDOUT,
                cwd=self.dir,
                env=child_env,
            )
            started[name] = {"pid": proc.pid, "started_at": time.time(),
                             "port": config["services"][name].get("port")}
        state["services"].update(started)
        self._save_state(state)
        return started

    # ------------------------------------------------------------------- stop
    @staticmethod
    def _alive(pid: Optional[int]) -> bool:
        if not pid:
            return False
        try:
            os.kill(pid, 0)
            return True
        except (ProcessLookupError, PermissionError):
            return False

    def stop(self) -> list[str]:
        state = self._load_state()
        stopped = []
        for name, info in state["services"].items():
            pid = info.get("pid")
            if self._alive(pid):
                try:
                    os.kill(pid, signal.SIGTERM)
                    stopped.append(name)
                except OSError:
                    pass
        deadline = time.time() + 5
        while time.time() < deadline and any(
                self._alive(i.get("pid"))
                for i in state["services"].values()):
            time.sleep(0.2)
        for info in state["services"].values():
            if self._alive(info.get("pid")):
                os.kill(info["pid"], signal.SIGKILL)
        state["services"] = {}
        self._save_state(state)
        return stopped

    def delete(self) -> None:
        import shutil

        self.stop()
        if os.path.isdir(self.dir):
            shutil.rmtree(self.dir)

    def status(self) -> dict:
        state = self._load_state()
        return {
            name: {**info, "alive": self._alive(info.get("pid"))}
            for name, info in state["services"].items()
        }


def list_deployments() -> list[dict]:
    out = []
    if not os.path.isdir(DEPLOY_ROOT):
        return out
    for name in sorted(os.listdir(DEPLOY_ROOT)):
        mgr = DeploymentManager(name)
        if mgr.exists():
            st = mgr.status()
            out.append({
                "name": name,
                "services": list(st),
                "running": sum(1 for s in st.values() if s["alive"]),
            })
    return out
