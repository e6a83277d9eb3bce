"""List the top FLOP / byte contributors of a dry-run's op records.

    python -m repro_torch.scripts.top_ops <tag.ops.jsonl> [flops|bytes] [N]

The twin of the reference's ``scripts/top_ops.py``, which walks a saved
HLO module and multiplies each instruction by its loops' trip counts.
The port's records (``launch.dryrun --save-ops``) hold one line per
dispatched op, so identical (op, output shapes and dtypes) records are
grouped and their count takes the place of the trip multiplier.
"""

from __future__ import annotations

import collections
import json
import sys


def load(path: str) -> list:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def rank(records: list, mode: str = "flops") -> list:
    """``(total, count, op, types)`` per group of identical records with a
    nonzero ``mode`` value, largest first."""
    if mode not in ("flops", "bytes"):
        raise ValueError(f"mode {mode!r}: flops or bytes")
    groups: dict = collections.defaultdict(lambda: [0, 0])
    for r in records:
        if not r[mode]:
            continue
        types = ",".join(f"{d}{s}" for d, s in zip(r["dtypes"], r["shapes"]))
        g = groups[(r["op"], types.replace(" ", ""))]
        g[0] += r[mode]
        g[1] += 1
    return sorted(((v, n, op, types) for (op, types), (v, n)
                   in groups.items()), reverse=True)


def main(path: str, mode: str = "flops", topn: int = 15) -> float:
    items = rank(load(path), mode)
    total = sum(i[0] for i in items)
    print(f"total {mode}: {total:.4e}")
    for val, n, op, types in items[:topn]:
        print(f"{val:.3e} x{n:<5d} {op:<42s} {types[:36]:<36s} "
              f"{val / n:.3e}/op")
    return total


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else "flops",
         int(sys.argv[3]) if len(sys.argv) > 3 else 15)
