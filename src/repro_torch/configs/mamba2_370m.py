"""mamba2-370m — SSD (state-space duality), attention-free [arXiv:2405.21060].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import MAMBA2_370M as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
