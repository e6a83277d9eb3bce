"""qwen2.5-14b — GQA with QKV bias [hf:Qwen/Qwen2.5-*].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import QWEN25_14B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
