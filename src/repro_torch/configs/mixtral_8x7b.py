"""mixtral-8x7b — 8 experts top-2, sliding-window attention [arXiv:2401.04088].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import MIXTRAL_8X7B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
