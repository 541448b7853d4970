"""Concrete providers: OpenAI, Anthropic, Gemini, OpenRouter, Local.

Copy of ``archi_tpu/providers/providers.py``.

Mirrors the reference's per-provider subclasses
(``src/archi/providers/openai_provider.py``, ``anthropic_provider.py``,
``gemini_provider.py``, ``openrouter_provider.py``, ``local_provider.py``).
The Local provider supports the reference's two modes
(``local_provider.py:18,75-125``): ``ollama`` (native API; model listing via
``/api/tags``) and ``openai_compat`` (vLLM etc.).
"""

from __future__ import annotations

from archi_tpu_torch.providers.base import (
    BaseProvider, ModelInfo, ProviderConfig, ProviderType,
)
from archi_tpu_torch.providers.chat_model import (
    AnthropicChatModel, BaseChatModel, EchoChatModel, GeminiChatModel,
    OpenAICompatChatModel,
)


class OpenAIProvider(BaseProvider):
    provider_type = ProviderType.OPENAI
    display_name = "OpenAI"
    DEFAULT_MODELS = [
        ModelInfo("gpt-5", "gpt-5", "GPT-5", context_window=400000),
        ModelInfo("gpt-5-mini", "gpt-5-mini", "GPT-5 Mini", context_window=400000),
        ModelInfo("gpt-4o", "gpt-4o", "GPT-4o", supports_vision=True),
        ModelInfo("gpt-4o-mini", "gpt-4o-mini", "GPT-4o Mini",
                  supports_vision=True),
    ]

    def get_chat_model(self, model_name: str, **kw) -> BaseChatModel:
        return OpenAICompatChatModel(
            model_name, api_key=self.api_key or "",
            base_url=self.config.base_url or "https://api.openai.com/v1",
            **{**self.config.extra_kwargs, **kw},
        )

    def list_models(self):
        return self.config.models or self.DEFAULT_MODELS


class AnthropicProvider(BaseProvider):
    provider_type = ProviderType.ANTHROPIC
    display_name = "Anthropic"
    DEFAULT_MODELS = [
        ModelInfo("claude-sonnet-4-5", "claude-sonnet-4-5", "Claude Sonnet 4.5",
                  context_window=200000, supports_vision=True),
        ModelInfo("claude-haiku-4-5", "claude-haiku-4-5", "Claude Haiku 4.5",
                  context_window=200000, supports_vision=True),
        ModelInfo("claude-opus-4-1", "claude-opus-4-1", "Claude Opus 4.1",
                  context_window=200000, supports_vision=True),
    ]

    def get_chat_model(self, model_name: str, **kw) -> BaseChatModel:
        return AnthropicChatModel(
            model_name, api_key=self.api_key or "",
            base_url=self.config.base_url or "https://api.anthropic.com",
            **{**self.config.extra_kwargs, **kw},
        )

    def list_models(self):
        return self.config.models or self.DEFAULT_MODELS


class GeminiProvider(BaseProvider):
    provider_type = ProviderType.GEMINI
    display_name = "Google Gemini"
    DEFAULT_MODELS = [
        ModelInfo("gemini-2.5-pro", "gemini-2.5-pro", "Gemini 2.5 Pro",
                  context_window=1000000, supports_vision=True),
        ModelInfo("gemini-2.5-flash", "gemini-2.5-flash", "Gemini 2.5 Flash",
                  context_window=1000000, supports_vision=True),
    ]

    def get_chat_model(self, model_name: str, **kw) -> BaseChatModel:
        return GeminiChatModel(
            model_name, api_key=self.api_key or "",
            **{**self.config.extra_kwargs, **kw},
        )

    def list_models(self):
        return self.config.models or self.DEFAULT_MODELS


class OpenRouterProvider(BaseProvider):
    provider_type = ProviderType.OPENROUTER
    display_name = "OpenRouter"

    def get_chat_model(self, model_name: str, **kw) -> BaseChatModel:
        return OpenAICompatChatModel(
            model_name, api_key=self.api_key or "",
            base_url=self.config.base_url or "https://openrouter.ai/api/v1",
            extra_headers={"HTTP-Referer": "https://archi-tpu",
                           "X-Title": "archi-tpu"},
            **{**self.config.extra_kwargs, **kw},
        )


class LocalProvider(BaseProvider):
    """Local model serving: mode 'ollama' or 'openai_compat' (vLLM, etc.),
    plus 'echo' for offline smoke tests."""

    provider_type = ProviderType.LOCAL
    display_name = "Local"

    @property
    def mode(self) -> str:
        return self.config.extra_kwargs.get("mode", "openai_compat")

    def get_chat_model(self, model_name: str, **kw) -> BaseChatModel:
        if self.mode == "echo" or model_name == "echo":
            # deterministic offline model (smoke tests / default pipelines)
            return EchoChatModel()
        base = self.config.base_url or "http://localhost:11434"
        if self.mode == "ollama":
            # Ollama serves the OpenAI protocol under /v1
            base = base.rstrip("/")
            if not base.endswith("/v1"):
                base = base + "/v1"
        extra = {k: v for k, v in self.config.extra_kwargs.items()
                 if k != "mode"}
        return OpenAICompatChatModel(
            model_name, api_key=self.api_key or "local",
            base_url=base, **{**extra, **kw},
        )

    def list_models(self) -> list[ModelInfo]:
        if self.config.models:
            return self.config.models
        if self.mode == "ollama":
            try:
                import requests

                r = requests.get(
                    f"{(self.config.base_url or 'http://localhost:11434').rstrip('/')}"
                    "/api/tags", timeout=5,
                )
                r.raise_for_status()
                return [
                    ModelInfo(m["name"], m["name"], m["name"],
                              context_window=8192)
                    for m in r.json().get("models", [])
                ]
            except Exception:
                return []
        return []


PROVIDER_CLASSES: dict[ProviderType, type[BaseProvider]] = {
    ProviderType.OPENAI: OpenAIProvider,
    ProviderType.ANTHROPIC: AnthropicProvider,
    ProviderType.GEMINI: GeminiProvider,
    ProviderType.OPENROUTER: OpenRouterProvider,
    ProviderType.LOCAL: LocalProvider,
}
