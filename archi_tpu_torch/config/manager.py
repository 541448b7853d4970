"""ConfigurationManager: YAML load + deep merge + validation.

Copy of ``archi_tpu/config/manager.py``.

Mirrors the reference's ``ConfigurationManager``
(``src/cli/managers/config_manager.py:16-160``): one or more user YAML files
merged over defaults, then validated against per-service required fields.
"""

from __future__ import annotations

from typing import Any, Sequence

from archi_tpu_torch.config.defaults import REQUIRED_FIELDS, default_config


class ConfigValidationError(ValueError):
    pass


def deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def get_path(config: dict, dotted: str, default=None):
    cur: Any = config
    for part in dotted.split("."):
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def set_path(config: dict, dotted: str, value) -> None:
    parts = dotted.split(".")
    cur = config
    for p in parts[:-1]:
        cur = cur.setdefault(p, {})
    cur[parts[-1]] = value


class ConfigurationManager:
    def __init__(self, config_paths: Sequence[str] = (),
                 overrides: dict | None = None):
        self.config = default_config()
        for path in config_paths:
            self.config = deep_merge(self.config, self._load_yaml(path))
        if overrides:
            self.config = deep_merge(self.config, overrides)

    @staticmethod
    def _load_yaml(path: str) -> dict:
        import yaml

        with open(path, encoding="utf-8") as f:
            data = yaml.safe_load(f) or {}
        if not isinstance(data, dict):
            raise ConfigValidationError(f"{path}: top level must be a mapping")
        return data

    def validate(self) -> list[str]:
        """→ list of problems; raises when an enabled service is broken."""
        problems = []
        services = self.config.get("services", {})
        ports_seen: dict[int, str] = {}
        for name, svc in services.items():
            if not isinstance(svc, dict) or not svc.get("enabled"):
                continue
            for field in REQUIRED_FIELDS.get(name, []):
                if get_path(self.config, field) is None:
                    problems.append(f"service {name}: missing {field}")
            port = svc.get("port")
            if port is not None:
                if port in ports_seen:
                    problems.append(
                        f"service {name}: port {port} already used by "
                        f"{ports_seen[port]}"
                    )
                ports_seen[port] = name
        dims = get_path(self.config, "data_manager.embedding_dimensions")
        if not isinstance(dims, int) or dims <= 0:
            problems.append("data_manager.embedding_dimensions must be a "
                            "positive integer")
        weights = get_path(
            self.config, "data_manager.retrievers.hybrid_retriever", {}
        )
        for w in ("bm25_weight", "semantic_weight"):
            v = weights.get(w)
            if v is not None and not (0.0 <= float(v) <= 1.0):
                problems.append(f"retrievers.hybrid_retriever.{w} must be "
                                "in [0, 1]")
        if problems:
            raise ConfigValidationError("; ".join(problems))
        return problems
