"""Share (%) of the device's idle time in the traced serving window (the
stretches no device operation covers, as ``idle_share.serve`` counts them)
that falls inside the serving thread's ``serve.wait_page`` spans: the card
idle while the serving loop waits for preprocessed pages."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None or not trace.ops:
        return None
    waits = ps.serving(spans, "serve.wait_page")
    idle = ps.idle(trace)
    if not waits or not idle:
        return None
    return 100.0 * ps.overlap(idle, ps.intervals(waits, trace)) / \
        ps.length(idle)
