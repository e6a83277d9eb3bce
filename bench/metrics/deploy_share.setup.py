"""deploy_share.setup: host seconds the program spent quantizing and
deploying its KAN stacks (``setup.seconds{phase=quantize}`` +
``{phase=deploy}``, read after the run) over ``setup_s``, in %.  One run
per process, as ``bench/run.py`` makes."""


def read(rec):
    from repro_torch import obs

    snap = obs.REGISTRY.snapshot()["metrics"]
    parts = [snap.get(f"setup.seconds{{phase={p}}}")
             for p in ("quantize", "deploy")]
    if None in parts or rec.setup_s <= 0:
        return None
    return 100.0 * sum(p["value"] for p in parts) / rec.setup_s
