"""Milliseconds each page's preprocess call waited (for the interpreter
lock or for I/O) rather than ran: the program's ``serve.preprocess`` span's
wall time less its thread's CPU time, averaged over the pages preprocessed
in the traced window."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    return ps.mean_ms(s.wall_ns - s.cpu_ns
                      for s in ps.started(spans, "serve.preprocess", trace))
