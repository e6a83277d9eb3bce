"""llama3-405b — dense GQA, 128k vocab [arXiv:2407.21783].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import LLAMA3_405B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
