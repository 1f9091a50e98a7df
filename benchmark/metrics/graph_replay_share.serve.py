"""Share (%) of the serving forwards that replayed as CUDA graphs: the
program's dispatch counters (``serve.graph_replays`` over it plus
``serve.eager_forwards``; a forward that captured counts in neither),
summed over the ``serve.dispatch`` spans of the traced window. None where
the program counts neither (one that runs every forward eagerly and keeps
no such counter)."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    dispatched = ps.started(spans, "serve.dispatch", trace)
    replays = sum(s.counts.get("serve.graph_replays", 0) for s in dispatched)
    eager = sum(s.counts.get("serve.eager_forwards", 0) for s in dispatched)
    return 100.0 * replays / (replays + eager) if replays + eager else None
