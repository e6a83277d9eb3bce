"""Model configurations: a copy of ``repro.configs`` (base + registry)."""

from .base import ModelConfig
from .registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "ModelConfig", "get_config", "smoke_config"]
