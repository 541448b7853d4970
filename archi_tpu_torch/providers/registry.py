"""Provider registry + factory functions.

Copy of ``archi_tpu/providers/registry.py``.

Mirrors the reference's module-level registry and factories
(``src/archi/providers/__init__.py:33-36,86-134,232-271,279-343``):
``get_provider``/``get_model``/``list_enabled_providers`` with a provider
instance cache, "provider/model" reference parsing, and
``get_chat_model_with_api_key`` for BYOK per-request keys.
"""

from __future__ import annotations

import threading
from typing import Any

from archi_tpu_torch.providers.base import (
    BaseProvider, ModelInfo, ProviderConfig, ProviderType,
)
from archi_tpu_torch.providers.chat_model import BaseChatModel
from archi_tpu_torch.providers.providers import PROVIDER_CLASSES

_DEFAULT_KEY_ENVS = {
    ProviderType.OPENAI: "OPENAI_API_KEY",
    ProviderType.ANTHROPIC: "ANTHROPIC_API_KEY",
    ProviderType.GEMINI: "GEMINI_API_KEY",
    ProviderType.OPENROUTER: "OPENROUTER_API_KEY",
    ProviderType.LOCAL: "",
}

_lock = threading.Lock()
_cache: dict[str, BaseProvider] = {}
_configs: dict[ProviderType, ProviderConfig] = {}


def configure_providers(config: dict[str, Any]) -> None:
    """Install provider configs from the framework config's ``providers``
    section (per-provider enabled/base_url/models/default_model)."""
    with _lock:
        _configs.clear()
        _cache.clear()
        for name, section in (config or {}).items():
            try:
                pt = ProviderType(name)
            except ValueError:
                continue
            models = [
                ModelInfo(**m) if isinstance(m, dict)
                else ModelInfo(m, m, m)
                for m in section.get("models", [])
            ]
            _configs[pt] = ProviderConfig(
                provider_type=pt,
                api_key_env=section.get("api_key_env",
                                        _DEFAULT_KEY_ENVS[pt]),
                api_key=section.get("api_key"),
                base_url=section.get("base_url"),
                enabled=section.get("enabled", True),
                models=models,
                default_model=section.get("default_model"),
                extra_kwargs=section.get("extra_kwargs", {}) or
                ({"mode": section["mode"]} if section.get("mode") else {}),
            )


def get_provider(provider: str | ProviderType,
                 *, fresh: bool = False) -> BaseProvider:
    pt = ProviderType(provider) if isinstance(provider, str) else provider
    key = pt.value
    with _lock:
        if not fresh and key in _cache:
            return _cache[key]
        config = _configs.get(pt) or ProviderConfig(
            provider_type=pt, api_key_env=_DEFAULT_KEY_ENVS[pt]
        )
        inst = PROVIDER_CLASSES[pt](config)
        if not fresh:
            _cache[key] = inst
        return inst


def parse_model_ref(ref: str) -> tuple[str, str]:
    """'provider/model' → (provider, model); bare model defaults to openai
    (reference model-ref convention in pipeline configs)."""
    if "/" in ref:
        p, m = ref.split("/", 1)
        try:
            ProviderType(p)
            return p, m
        except ValueError:
            pass
    return "openai", ref


def get_model(ref: str, **kwargs) -> BaseChatModel:
    provider_name, model_name = parse_model_ref(ref)
    provider = get_provider(provider_name)
    if not model_name:
        model_name = provider.config.default_model or ""
    return provider.get_chat_model(model_name, **kwargs)


def get_chat_model_with_api_key(ref: str, api_key: str,
                                **kwargs) -> BaseChatModel:
    """Per-request BYOK key without touching the cached provider."""
    provider_name, model_name = parse_model_ref(ref)
    provider = get_provider(provider_name, fresh=True)
    provider.set_api_key(api_key)
    return provider.get_chat_model(model_name, **kwargs)


def list_enabled_providers() -> list[dict]:
    out = []
    for pt in ProviderType:
        p = get_provider(pt)
        if p.is_enabled:
            out.append(p.to_dict())
    return out


def list_all_providers() -> list[dict]:
    return [get_provider(pt).to_dict() for pt in ProviderType]
