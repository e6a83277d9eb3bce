"""recurrentgemma-9b — RG-LRU + local attention 2:1 [arXiv:2402.19427].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import RECURRENTGEMMA_9B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
