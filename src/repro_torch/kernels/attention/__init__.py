"""Kernel B2: flash attention (online softmax over KV tiles, GQA-aware).

:mod:`.ops` is the model-facing wrapper (the hand-written CUDA kernel on
CUDA tensors, the plain version on CPU tensors), :mod:`.ref` the plain
PyTorch version of the same recurrence, :mod:`.cardcheck` the kernel held
against it on the card.
"""

from .ops import (
    KINDS,
    MLA_DIMS,
    MMA_HEAD_DIMS,
    NEG_INF,
    SUPPORTED_HEAD_DIMS,
    b2_instance,
    call_kv_splits,
    flash_attention,
    mla_attention,
    mla_split_count,
)
from .ref import flash_attention_plain, kv_split_count, mma_block_k

__all__ = ["KINDS", "MLA_DIMS", "MMA_HEAD_DIMS", "NEG_INF",
           "SUPPORTED_HEAD_DIMS", "b2_instance", "call_kv_splits",
           "flash_attention", "flash_attention_plain", "kv_split_count",
           "mla_attention", "mla_split_count", "mma_block_k"]
