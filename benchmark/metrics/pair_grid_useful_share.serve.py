"""Share (%) of the pair cells the decoder computed that belong to a real
page: the program's dispatch counters (``serve.pair_cells_real``, the
upper triangle of each real page's positions after CLS, over
``serve.pair_cells_computed``, the row blocks ``models/decoder.py``
computes for every row of the batch), summed over the ``serve.dispatch``
spans of the traced window."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    dispatched = ps.started(spans, "serve.dispatch", trace)
    real = sum(s.counts.get("serve.pair_cells_real", 0) for s in dispatched)
    computed = sum(s.counts.get("serve.pair_cells_computed", 0)
                   for s in dispatched)
    return 100.0 * real / computed if computed else None
