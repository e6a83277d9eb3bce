"""peak_mem_gib.lm: ``torch.cuda.max_memory_allocated`` over the window,
in GiB (weights, deployed bundles, the KV cache and the step's
activations)."""


def read(rec):
    return None if rec.device_trace is None else rec.peak_bytes / 2**30
