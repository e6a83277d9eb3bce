"""The port's paged KV pool (a near-verbatim copy) vs the reference's.

The same operation sequences (allocation, release, prefix matching and
publishing, truncation, eviction under pressure) drive both pools; after
every operation their returned values, exceptions, counters and internal
state must be equal.
"""

import numpy as np
import pytest

from repro.serve import kvpool as jkv
from repro_torch.serve import kvpool as tkv


def _state(pool) -> tuple:
    return (list(pool._free), list(pool._ref), dict(pool._hash_to_block),
            dict(pool._block_hash), list(pool._evictable), pool.stats())


def _apply(pool, op, args):
    try:
        return ("ok", getattr(pool, op)(*args))
    except (tkv.KVPoolExhausted, jkv.KVPoolExhausted) as e:
        return ("exhausted", str(e))
    except ValueError as e:
        return ("value_error", str(e))


class _Twin:
    """Runs each operation on both pools and holds results and state equal."""

    def __init__(self, pools):
        self.pools = pools

    def __call__(self, op, *args):
        outs = []
        for pool in self.pools:
            a = tuple(list(x) if isinstance(x, list) else x for x in args)
            outs.append((_apply(pool, op, a), a))
        (want, wargs), (got, gargs) = outs
        assert got == want and gargs == wargs, (op, args)
        assert _state(self.pools[1]) == _state(self.pools[0]), (op, args)
        return want, wargs


def _drive(twin, seed: int, steps: int = 120, bs: int = 8) -> None:
    """An engine-like client: requests over prompts that share prefixes are
    admitted (prefix match, then blocks for the rest, then publish), grow
    by decode blocks, roll back speculative tails, and finish (release),
    with the pool small enough to exhaust and evict."""
    rng = np.random.default_rng(seed)
    base = rng.integers(3, 50, 40).tolist()
    prompts = [base[:k] + rng.integers(3, 50, 9).tolist()
               for k in (0, 8, 16, 24, 33)]
    live: list = []                    # (prompt, chain) per running request
    for _ in range(steps):
        r = rng.random()
        if r < 0.4 or not live:
            p = prompts[rng.integers(len(prompts))]
            (_, reused), _ = twin("match_prefix", p, len(p) - 1)
            chain = list(reused)
            ok = True
            while len(chain) < -(-len(p) // bs):
                (kind, bid), _ = twin("alloc")
                if kind != "ok":
                    ok = False
                    break
                chain.append(bid)
            if not ok:
                for bid in chain:
                    twin("release", bid)
                continue
            twin("publish_prefix", p, chain[:len(p) // bs])
            live.append((p, chain))
        elif r < 0.6:
            _, chain = live[rng.integers(len(live))]
            (kind, bid), _ = twin("alloc")
            if kind == "ok":
                chain.append(bid)
        elif r < 0.75:
            p, chain = live[rng.integers(len(live))]
            new_len = int(rng.integers(len(p), len(chain) * bs + 1))
            _, cut = twin("truncate", chain, new_len)
            chain[:] = cut[0]
        else:
            _, chain = live.pop(rng.integers(len(live)))
            for bid in chain:
                twin("release", bid)


@pytest.mark.parametrize("prefix_cache", [True, False])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_operations_same_state(seed, prefix_cache):
    pools = [jkv.KVBlockPool(12, 8, prefix_cache=prefix_cache),
             tkv.KVBlockPool(12, 8, prefix_cache=prefix_cache)]
    _drive(_Twin(pools), seed)
    for pool in pools:
        pool.check_consistent()
    assert pools[1].stats() == pools[0].stats()
    assert pools[0].stats()["allocs"] > 0


def test_hashes_and_errors_match():
    toks = list(range(3, 40))
    assert tkv.hash_token_blocks(toks, 8) == jkv.hash_token_blocks(toks, 8)
    assert tkv.SCRATCH_BLOCK == jkv.SCRATCH_BLOCK == 0
    for mod in (tkv, jkv):
        with pytest.raises(ValueError):
            mod.KVBlockPool(1, 8)
        with pytest.raises(ValueError):
            mod.KVBlockPool(4, 0)
