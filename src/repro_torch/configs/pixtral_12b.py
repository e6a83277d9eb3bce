"""pixtral-12b — ViT patch stub + mistral-nemo backbone [hf:mistralai/Pixtral-12B-2409].

The assigned config (``CONFIG``, the literal numbers in registry.py) and
its reduced CPU-test variant (``SMOKE``, ``smoke_config``).
"""

from .registry import PIXTRAL_12B as CONFIG
from .registry import smoke_config

SMOKE = smoke_config(CONFIG.name)
