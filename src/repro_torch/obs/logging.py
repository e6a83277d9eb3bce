"""Structured, leveled logging for the serve/runtime stack.

Port of ``repro.obs.logging``.

One logger replaces the ad-hoc ``log=`` lambdas that grew across the
scheduler and ``launch.serve``: every record is one line of
``level event key=value ...`` text built from structured fields, filtered
by a level threshold (``REPRO_LOG_LEVEL`` env var, or per-logger
``level=``), and written through a pluggable sink.

Back-compat is explicit: :func:`as_logger` turns the legacy bare-callable
``log=`` argument (e.g. ``log=print``) into a :class:`Logger` whose sink
is that callable and whose threshold is DEBUG — a caller who passed a
lambda keeps receiving every message, formatted exactly as the f-strings
it used to get.  ``Logger.__call__`` aliases :meth:`Logger.info`, so code
holding a logger can still invoke it like the old lambda.

    from repro_torch import obs
    log = obs.get_logger("serve")
    log.info("request done", rid=3, tokens=17, latency_s=0.042)
    # -> "serve: request done rid=3 tokens=17 latency_s=0.042"
"""

from __future__ import annotations

import os
import sys

__all__ = ["Logger", "get_logger", "as_logger", "LEVELS", "ENV_LOG_LEVEL_VAR"]

ENV_LOG_LEVEL_VAR = "REPRO_LOG_LEVEL"

LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40}


def _env_level() -> int:
    raw = os.environ.get(ENV_LOG_LEVEL_VAR, "").strip().lower()
    return LEVELS.get(raw, LEVELS["info"])


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    s = str(v)
    return repr(s) if " " in s else s


class Logger:
    """Leveled structured logger writing one-line records to a sink.

    ``sink`` is any ``callable(str)`` (default: stdout write);
    ``level=None`` reads ``REPRO_LOG_LEVEL`` at each record, so the env
    var takes effect without plumbing.
    """

    def __init__(self, name: str = "", sink=None, level: str | None = None):
        self.name = name
        self.sink = sink if sink is not None else (
            lambda line: print(line, file=sys.stdout, flush=True))
        self._level = None if level is None else LEVELS[level]

    def threshold(self) -> int:
        return self._level if self._level is not None else _env_level()

    def enabled_for(self, level: str) -> bool:
        return LEVELS[level] >= self.threshold()

    def log(self, level: str, event: str, **fields) -> None:
        if LEVELS[level] < self.threshold():
            return
        parts = [event] + [f"{k}={_fmt_value(v)}" for k, v in fields.items()]
        prefix = f"{self.name}: " if self.name else ""
        lvl = "" if level == "info" else f"[{level}] "
        self.sink(f"{prefix}{lvl}{' '.join(parts)}")

    def debug(self, event: str, **fields) -> None:
        self.log("debug", event, **fields)

    def info(self, event: str, **fields) -> None:
        self.log("info", event, **fields)

    def warning(self, event: str, **fields) -> None:
        self.log("warning", event, **fields)

    def error(self, event: str, **fields) -> None:
        self.log("error", event, **fields)

    # the legacy ``log=`` lambdas were called directly; keep that shape
    __call__ = info


_LOGGERS: dict = {}


def get_logger(name: str = "") -> Logger:
    """Process-wide named logger (stdout sink, env-var threshold)."""
    lg = _LOGGERS.get(name)
    if lg is None:
        lg = _LOGGERS[name] = Logger(name)
    return lg


def as_logger(log, name: str = "") -> Logger:
    """Normalize a ``log=`` argument to a :class:`Logger`.

    ``None`` -> the named process logger; a :class:`Logger` -> itself; any
    other callable -> the bare-lambda back-compat path: a DEBUG-threshold
    logger sinking every formatted line into the callable (the behavior
    callers of ``Scheduler(log=print)`` always had).
    """
    if log is None:
        return get_logger(name)
    if isinstance(log, Logger):
        return log
    if callable(log):
        return Logger(name="", sink=log, level="debug")
    raise TypeError(f"log must be None, a Logger or a callable; got {log!r}")
