"""Obs-artifact validator for the port's served workloads.

The twin of the reference's ``scripts/check_obs.py`` on
``repro_torch.obs.parse_prometheus_text``.  Takes the files a served
workload wrote (``python -m repro_torch.launch.serve --metrics-dump /
--trace-out``) and refuses anything malformed:

  * **Prometheus dumps** — must parse under the STRICT
    ``repro_torch.obs.parse_prometheus_text`` (every non-comment line a valid
    sample), and must cover the documented name families: at least one
    ``serve_*``, ``plan_cache_*`` sample (``kv_*`` too when the workload
    ran a paged engine — checked when present).
  * **JSON snapshots** — ``{"metrics": {series: {"kind", "value"}}}`` with
    every kind one of counter/gauge/histogram and histogram values
    carrying consistent edges/counts/count.
  * **JSONL traces** — every line schema-checked (type/name/id/parent/rid/
    t0/attrs; spans also t1), ids strictly increasing, parents resolving
    to earlier spans, every span closed (t1 >= t0), and each traced
    request carrying the full documented taxonomy: a ``request`` span with
    ``queued`` child, a terminal status, and — for served requests — a
    ``first_token`` event between ``prefill`` and ``decode``.

    python -m repro_torch.scripts.check_obs \
        --prom metrics.prom --json metrics.json --trace trace.jsonl
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def check_prom(path: str) -> list:
    from ..obs import parse_prometheus_text

    errors = []
    try:
        samples = parse_prometheus_text(Path(path).read_text())
    except ValueError as e:
        return [f"{path}: {e}"]
    if not samples:
        return [f"{path}: no samples at all"]
    for family in ("serve_", "plan_cache_"):
        if not any(name.startswith(family) for name in samples):
            errors.append(f"{path}: no {family}* samples")
    # histogram exposition consistency: every _bucket family needs its
    # _count, and the +Inf bucket must equal it
    for name, v in samples.items():
        if '_bucket{le="+Inf"}' in name:
            base = name.split("_bucket{")[0]
            count = samples.get(f"{base}_count")
            if count is None:
                errors.append(f"{path}: {base}_bucket without {base}_count")
            elif v != count:
                errors.append(f"{path}: {base} +Inf bucket {v} != count "
                              f"{count}")
    print(f"{path}: {len(samples)} samples ok")
    return errors


def check_json(path: str) -> list:
    errors = []
    doc = json.loads(Path(path).read_text())
    metrics = doc.get("metrics")
    if not isinstance(metrics, dict) or not metrics:
        return [f"{path}: missing/empty 'metrics' object"]
    for series, entry in metrics.items():
        kind = entry.get("kind")
        if kind not in ("counter", "gauge", "histogram"):
            errors.append(f"{path}: {series}: bad kind {kind!r}")
            continue
        v = entry.get("value")
        if kind == "histogram":
            if (not isinstance(v, dict)
                    or len(v.get("counts", [])) != len(v.get("edges", [])) + 1
                    or sum(v["counts"]) != v.get("count")):
                errors.append(f"{path}: {series}: inconsistent histogram")
        elif not isinstance(v, (int, float)):
            errors.append(f"{path}: {series}: non-numeric value {v!r}")
    print(f"{path}: {len(metrics)} series ok")
    return errors


SPAN_KEYS = {"type", "name", "id", "parent", "rid", "t0", "t1", "attrs"}
EVENT_KEYS = {"type", "name", "id", "parent", "rid", "t0", "attrs"}


def check_trace(path: str) -> list:
    errors = []
    spans: dict = {}
    by_rid: dict = {}
    last_id = -1
    for i, line in enumerate(Path(path).read_text().splitlines(), 1):
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            errors.append(f"{path}:{i}: not JSON: {e}")
            continue
        t = rec.get("type")
        if t == "meta":
            continue
        want = SPAN_KEYS if t == "span" else EVENT_KEYS
        if t not in ("span", "event") or set(rec) != want:
            errors.append(f"{path}:{i}: bad record shape: {sorted(rec)}")
            continue
        if rec["id"] <= last_id:
            errors.append(f"{path}:{i}: ids not strictly increasing")
        last_id = rec["id"]
        if rec["parent"] is not None and rec["parent"] not in spans:
            errors.append(f"{path}:{i}: parent {rec['parent']} not an "
                          f"earlier span")
        if t == "span":
            if rec["t1"] is None or rec["t1"] < rec["t0"]:
                errors.append(f"{path}:{i}: span {rec['name']}#{rec['id']} "
                              f"not closed or negative ({rec['t1']})")
            spans[rec["id"]] = rec
        if rec["rid"] is not None:
            by_rid.setdefault(rec["rid"], {}).setdefault(
                rec["name"], []).append(rec)
    if not by_rid:
        errors.append(f"{path}: no per-request records at all")
    for rid, names in sorted(by_rid.items()):
        if "request" not in names or "queued" not in names:
            errors.append(f"{path}: rid {rid}: missing request/queued span")
            continue
        status = names["request"][0]["attrs"].get("status")
        if status not in ("done", "expired"):
            errors.append(f"{path}: rid {rid}: bad terminal status {status!r}")
        if status == "done":
            for name in ("prefill", "first_token", "decode"):
                if name not in names:
                    errors.append(f"{path}: rid {rid}: served request "
                                  f"missing {name}")
    print(f"{path}: {last_id + 1} records, {len(by_rid)} requests ok")
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.scripts.check_obs")
    ap.add_argument("--prom", action="append", default=[],
                    help="Prometheus text dump(s) to validate")
    ap.add_argument("--json", action="append", default=[], dest="json_",
                    help="JSON metrics snapshot(s) to validate")
    ap.add_argument("--trace", action="append", default=[],
                    help="JSONL trace file(s) to validate")
    args = ap.parse_args(argv)
    if not (args.prom or args.json_ or args.trace):
        ap.error("nothing to check: pass --prom/--json/--trace")
    errors = []
    for p in args.prom:
        errors += check_prom(p)
    for p in args.json_:
        errors += check_json(p)
    for p in args.trace:
        errors += check_trace(p)
    if errors:
        print("\nFAIL:")
        for e in errors:
            print(f"  {e}")
        return 1
    print("obs artifacts OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
