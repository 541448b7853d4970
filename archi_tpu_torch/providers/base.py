"""Provider abstraction: types, config, and the provider ABC.

Copy of ``archi_tpu/providers/base.py``.

Mirrors the reference's provider layer contracts
(``src/archi/providers/base.py:21-191``): ``ProviderType`` enum,
``ModelInfo``, ``ProviderConfig``, and ``BaseProvider`` with api-key
resolution (secrets/env/BYOK), enablement, and model listing — but
``get_chat_model`` returns our HTTP-native ``BaseChatModel``
(``archi_tpu_torch.providers.chat_model``) instead of a LangChain object.
"""

from __future__ import annotations

import dataclasses
import enum
import os
from abc import ABC, abstractmethod
from typing import Any, Optional

from archi_tpu_torch.providers.chat_model import BaseChatModel


class ProviderType(str, enum.Enum):
    OPENAI = "openai"
    ANTHROPIC = "anthropic"
    GEMINI = "gemini"
    OPENROUTER = "openrouter"
    LOCAL = "local"


@dataclasses.dataclass
class ModelInfo:
    id: str
    name: str
    display_name: str
    context_window: int = 128000
    supports_tools: bool = True
    supports_streaming: bool = True
    supports_vision: bool = False
    max_output_tokens: Optional[int] = None

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ProviderConfig:
    provider_type: ProviderType
    api_key_env: str = ""
    api_key: Optional[str] = None
    base_url: Optional[str] = None
    enabled: bool = True
    models: list[ModelInfo] = dataclasses.field(default_factory=list)
    default_model: Optional[str] = None
    extra_kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)


def read_secret(name: str) -> Optional[str]:
    """Secret resolution: ``NAME_FILE`` mount wins, else env var (reference
    ``src/utils/env.py:4``)."""
    file_var = os.environ.get(f"{name}_FILE")
    if file_var and os.path.exists(file_var):
        with open(file_var) as f:
            return f.read().strip()
    return os.environ.get(name)


class BaseProvider(ABC):
    provider_type: ProviderType
    display_name: str = "provider"

    def __init__(self, config: ProviderConfig):
        self.config = config
        self._api_key: Optional[str] = None
        self._load_api_key()

    def _load_api_key(self) -> None:
        if self.config.api_key:
            self._api_key = self.config.api_key
        elif self.config.api_key_env:
            self._api_key = read_secret(self.config.api_key_env)

    @property
    def api_key(self) -> Optional[str]:
        return self._api_key

    @api_key.setter
    def api_key(self, value: Optional[str]) -> None:
        self._api_key = value

    def set_api_key(self, api_key: str) -> None:
        self._api_key = api_key

    @property
    def is_configured(self) -> bool:
        if self.provider_type == ProviderType.LOCAL:
            return bool(self.config.base_url)
        return bool(self._api_key)

    @property
    def is_enabled(self) -> bool:
        return self.config.enabled and self.is_configured

    @abstractmethod
    def get_chat_model(self, model_name: str, **kwargs) -> BaseChatModel:
        ...

    def list_models(self) -> list[ModelInfo]:
        return list(self.config.models)

    def validate_credentials(self) -> bool:
        """Cheap credential check; providers may override with a live ping."""
        return self.is_configured

    def to_dict(self) -> dict[str, Any]:
        return {
            "provider_type": self.provider_type.value,
            "display_name": self.display_name,
            "enabled": self.is_enabled,
            "configured": self.is_configured,
            "models": [m.to_dict() for m in self.list_models()],
            "default_model": self.config.default_model,
        }
