"""Wall milliseconds of each batch's dispatch (the program's
``serve.dispatch`` span: stack the pages, copy them to the device, launch
the forward), averaged over the batches dispatched in the traced window."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    return ps.mean_ms(s.wall_ns
                      for s in ps.started(spans, "serve.dispatch", trace))
