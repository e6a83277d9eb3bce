"""whisper-base — enc-dec; conv frontend stubbed to frame embeddings [arXiv:2212.04356].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import WHISPER_BASE as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
