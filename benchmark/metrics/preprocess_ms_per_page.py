"""Host CPU milliseconds of each page's preprocess call (tokenize, reading
order, boxes, padding: ``pipeline/preprocess.py`` ``PagePreprocessor``),
timed by the benchmark's wrapper around the callable ``page_preprocessor()``
returns, averaged over the traced window's pages."""


def read(run, trace):
    calls = run["spans"].get("preprocess") or []
    return 1e3 * sum(calls) / len(calls) if calls else None
