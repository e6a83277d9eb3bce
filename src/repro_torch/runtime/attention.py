"""Attention-backend registry: the dispatch point for SDPA execution.

Port of ``repro.runtime.attention``.  Entries are NAMES; the
implementations live in :mod:`repro_torch.models.layers` (``_sdpa``
dispatches on the resolved name), so this module imports nothing else of
the port.

Registered backends:

  * ``"ref"``   - the chunked composition (``layers._sdpa_ref``):
                  position-built masks, query chunking, guarded masked
                  softmax.  The parity oracle.
  * ``"flash"`` - kernel B2 (:mod:`repro_torch.kernels.attention`): online
                  softmax over KV tiles, GQA-aware.  On CUDA tensors it
                  launches the hand-written kernel; on CPU tensors it takes
                  the kernel's plain version.

Selection precedence matches the KAN registry: explicit argument >
:func:`use_attn_backend` scope > ``REPRO_ATTN_BACKEND`` > the default,
``"flash"``.  (The reference defaults to "ref" off-TPU because its Pallas
kernel would run interpreted there; here the default is the kernel.)
PyTorch runs eagerly, so a scope change takes effect at the next call.
"""

from __future__ import annotations

import collections
import contextlib
import contextvars
import os

__all__ = [
    "ENV_ATTN_BACKEND_VAR",
    "attn_dispatch_counts",
    "available_attn_backends",
    "default_attn_backend",
    "register_attn_backend",
    "reset_attn_dispatch_counts",
    "resolve_attn_backend",
    "use_attn_backend",
]

ENV_ATTN_BACKEND_VAR = "REPRO_ATTN_BACKEND"

_ATTN_BACKENDS: list = []
# attention calls by resolved backend: one increment per SDPA call of a
# layer (models.layers._sdpa / _sdpa_decode)
ATTN_DISPATCH_COUNTS: collections.Counter = collections.Counter()
# innermost use_attn_backend() override; a ContextVar so concurrent engines
# on different threads or tasks cannot clobber each other's scope
_SCOPE_ATTN: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_attn_backend_scope", default=None
)


def attn_dispatch_counts() -> dict:
    """Attention calls by backend since start or the last reset."""
    return dict(ATTN_DISPATCH_COUNTS)


def reset_attn_dispatch_counts() -> None:
    ATTN_DISPATCH_COUNTS.clear()


def register_attn_backend(name: str) -> None:
    if name not in _ATTN_BACKENDS:
        _ATTN_BACKENDS.append(name)


def available_attn_backends() -> tuple:
    return tuple(sorted(_ATTN_BACKENDS))


def default_attn_backend() -> str:
    """"flash": kernel B2 on the card, its plain version on the CPU."""
    return "flash"


def _check(backend: str) -> None:
    if backend not in _ATTN_BACKENDS:
        raise ValueError(
            f"unknown attention backend {backend!r}; "
            f"registered: {available_attn_backends()}"
        )


def resolve_attn_backend(backend: str | None = None, *,
                         default: str | None = None) -> str:
    """Resolve an attention backend name; ValueError for unknown names."""
    if backend is None or backend == "auto":
        backend = _SCOPE_ATTN.get()
    if backend is None:
        backend = os.environ.get(ENV_ATTN_BACKEND_VAR, "").strip() or None
    if backend is None:
        backend = default_attn_backend() if default is None else default
    _check(backend)
    return backend


@contextlib.contextmanager
def use_attn_backend(backend: str | None):
    """Scoped override (beats the env var, loses to explicit arguments).

    ``None`` is a passthrough so callers can plumb an optional choice.
    """
    if backend is not None:
        _check(backend)
    token = _SCOPE_ATTN.set(
        backend if backend is not None else _SCOPE_ATTN.get()
    )
    try:
        yield
    finally:
        _SCOPE_ATTN.reset(token)


register_attn_backend("ref")
register_attn_backend("flash")
