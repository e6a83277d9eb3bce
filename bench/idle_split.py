"""Run one cell traced and split its traced slice by the program's ranges.

    python bench/idle_split.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as ``bench/run.py --trace 1`` does and prints one JSON line:
``result`` (the line ``run.py`` would print), ``idle_by_range`` (the
slice's idle seconds by the innermost program range the host was in while
the device idled), ``host_by_range`` (the slice's wall by innermost range,
prefills counted whole), ``pad_sent`` (the real and the bucket-padded
rows or prompt tokens reckoned from the sizes the client sent in the
slice, beside which ``pad_share.*`` must read the same) and, for LM
cells, ``decode_calls`` and ``host_ms_per_decode`` (``host_by_range``
outside prefills, in ms per decode step).  The split is
``benchlib.program``'s; nothing here is a metric of ``BENCHMARK.json``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH.parent / "src"), str(BENCH)]


def keeping(manifest_cls, kept: list):
    """``manifest_cls`` with each generator's record appended to
    ``kept``, for the split."""

    class Keep(manifest_cls):
        def generator(self, kind):
            gen = super().generator(kind)

            def run(ctx):
                kept.append(gen.run(ctx))
                return kept[-1]

            return types.SimpleNamespace(run=run)

    return Keep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchlib import program
    from benchlib.harness import run_cell
    from benchlib.manifest import Manifest
    from benchlib.work import ceil_pow2

    kept = []
    out = run_cell(args.workload, args.seed, args.seconds, True, args.device,
                   t_start=T_START,
                   manifest=keeping(Manifest, kept)(BENCH.parent))
    rec = kept[-1]
    t = rec.trace
    split = {"result": out, "window_s": t.window_s,
             "idle_by_range": program.idle_by_range(t),
             "host_by_range": program.host_by_range(t)}
    if hasattr(rec, "traced_rows"):
        sizes, cap = rec.traced_rows, None
    else:
        sizes = [n for step in rec.traced_steps for n in step["prefills"]]
        cap = rec.mix["max_len"] - 1
    pad = sum(ceil_pow2(n) - n for n in sizes
              if cap is None or ceil_pow2(n) <= cap)
    split["pad_sent"] = {"real": sum(sizes), "pad": pad,
                         "share": program.share(pad, sum(sizes) + pad)}
    calls = getattr(rec, "traced_decode_calls", 0)
    if calls:
        split["decode_calls"] = calls
        split["host_ms_per_decode"] = {
            k: 1e3 * v / calls for k, v in split["host_by_range"].items()
            if k != "serve.prefill"}
    print(json.dumps(split), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
