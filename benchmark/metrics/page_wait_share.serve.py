"""Share (%) of the traced serving window in which the serving thread
waited for the next preprocessed page: the program's ``serve.wait_page``
spans (``pipeline/infer.py`` ``PageServer.run``) on the thread of its
``serve.run`` spans, clipped to the window."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    waits = ps.serving(spans, "serve.wait_page")
    if not waits:
        return None
    return 100.0 * ps.length(ps.intervals(waits, trace)) / (
        trace.end_ns - trace.start_ns)
