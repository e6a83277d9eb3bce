"""Deterministic, seekable synthetic token pipeline.

A numpy copy of ``repro.data.lm_data`` (the port imports nothing of the
JAX package); the same ``(seed, step, host_id, num_hosts)`` gives the same
arrays, bit for bit.  Every batch is a pure function of those, so

  * **determinism**: restart at step K reproduces the exact stream (no data
    loss or duplication after checkpoint restore);
  * **host sharding**: each host materializes only its slice of the global
    batch;
  * **packing**: documents of random length are packed into fixed seq_len
    rows with EOS separators, emulating a packed pretraining pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "global_batch_at_step", "host_batch_at_step"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 2
    mean_doc_len: int = 512


def _doc_stream(rng: np.random.Generator, n_tokens: int, cfg: DataConfig):
    """Markov-ish synthetic tokens packed with EOS boundaries."""
    out = np.empty(n_tokens, np.int32)
    i = 0
    while i < n_tokens:
        dlen = min(int(rng.exponential(cfg.mean_doc_len)) + 8, n_tokens - i)
        start = rng.integers(3, cfg.vocab_size)
        walk = rng.integers(-64, 65, size=dlen).cumsum() + start
        out[i : i + dlen] = np.clip(np.abs(walk) % cfg.vocab_size, 3, None)
        i += dlen
        if i < n_tokens:
            out[i] = cfg.eos_id
            i += 1
    return out


def _rows(rng: np.random.Generator, rows: int, cfg: DataConfig) -> dict:
    toks = _doc_stream(rng, rows * (cfg.seq_len + 1), cfg)
    toks = toks.reshape(rows, cfg.seq_len + 1)
    return {"tokens": toks[:, :-1].copy(), "targets": toks[:, 1:].copy()}


def global_batch_at_step(cfg: DataConfig, step: int) -> dict:
    """The full (global_batch, seq_len) int32 tokens/targets for one step."""
    return _rows(np.random.default_rng((cfg.seed, step)), cfg.global_batch,
                 cfg)


def host_batch_at_step(cfg: DataConfig, step: int, host_id: int,
                       num_hosts: int) -> dict:
    """Deterministic per-host slice (seek = just pass the step)."""
    if cfg.global_batch % num_hosts:
        raise ValueError(f"global_batch {cfg.global_batch} is not a multiple "
                         f"of num_hosts {num_hosts}")
    return _rows(np.random.default_rng((cfg.seed, step, host_id)),
                 cfg.global_batch // num_hosts, cfg)
