"""Share (%) of the traced serving window in which no operation ran on the
device, from the profiler's device operations."""


def read(run, trace):
    if trace is None or not trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
