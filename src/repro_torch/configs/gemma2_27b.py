"""gemma2-27b — local+global alternating, logit softcaps [arXiv:2408.00118; hf].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import GEMMA2_27B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
