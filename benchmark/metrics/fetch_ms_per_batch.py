"""Wall milliseconds of each batch's fetch (the program's ``serve.fetch``
span: wait for the batch's forward, then copy its spots to the host, queued
behind the batches dispatched after it), averaged over the batches fetched
in the traced window."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    return ps.mean_ms(s.wall_ns
                      for s in ps.started(spans, "serve.fetch", trace))
