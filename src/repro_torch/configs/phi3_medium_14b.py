"""phi3-medium-14b — RoPE SwiGLU GQA [arXiv:2404.14219].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import PHI3_MEDIUM as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
