"""launches_per_call: the kernels the device trace counts in the traced
window, over the calls in it."""


def value(run):
    if run.trace is None or not run.trace.spans:
        return None
    lo, hi = run.trace.window
    n = len(run.trace.kernels(lo, hi))
    return n / len(run.trace.spans) if n else None
