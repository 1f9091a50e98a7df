"""Host CPU milliseconds of each page's decode call (``pipeline/decode.py``
``decode_page_record``, the native chain walk of ``native/decode.cpp``),
timed by the benchmark's wrapper, averaged over the traced window's pages."""


def read(run, trace):
    calls = run["spans"].get("decode") or []
    return 1e3 * sum(calls) / len(calls) if calls else None
