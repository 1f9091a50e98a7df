"""Device milliseconds of the backbone (``models/lilt.py``) a batch: the
device operations launched inside the profiler range that the benchmark's
forward hooks open around the model's backbone module, averaged over the
traced window's batches."""


def read(run, trace):
    if trace is None:
        return None
    per_batch = trace.span_device_s("bench.backbone")
    return 1e3 * sum(per_batch) / len(per_batch) if per_batch else None
