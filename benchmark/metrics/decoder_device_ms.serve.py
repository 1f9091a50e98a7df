"""Device milliseconds of the decoder a batch (``models/decoder.py``: the
shrink MLP, the pair head over the upper triangle, the spot compaction):
the device operations launched inside the profiler range that the
benchmark's forward hooks open around the model's decoder module, averaged
over the traced window's batches."""


def read(run, trace):
    if trace is None:
        return None
    per_batch = trace.span_device_s("bench.decoder")
    return 1e3 * sum(per_batch) / len(per_batch) if per_batch else None
