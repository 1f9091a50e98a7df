"""Host CPU milliseconds of each page image's load (the program's
``serve.preprocess.image`` span inside ``pipeline/preprocess.py``
``PagePreprocessor``: decode, resize to the model's input size and the
uint8 array), its thread's CPU time, averaged over the images loaded in the
traced window. None where the program opens no such span (a text-only
model, or a program older than the span)."""


def read(run, trace):
    from benchmark import program_spans as ps

    spans = ps.window(trace)
    if spans is None:
        return None
    return ps.mean_ms(s.cpu_ns for s in ps.started(
        spans, "serve.preprocess.image", trace))
