"""olmoe-1b-7b — 64 experts top-8 [arXiv:2409.02060].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import OLMOE_1B_7B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
