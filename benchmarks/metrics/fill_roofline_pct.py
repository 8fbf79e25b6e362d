"""fill_roofline_pct: the least time the card could take for the fill of
the cells the window's completed calls asked for (``roofline.Peak``:
the fewest instructions a cell needs at the card's issue rate, in lanes
of the configuration's precision, or inputs and outputs once at the
memory rate, whichever is longer), over the device time of every kernel the window ran, in %. It
names no kernel. Nothing to read without a trace or a kernel."""


def value(run):
    if run.trace is None or run.peak is None:
        return None
    lo, hi = run.trace.window
    kernel_s = sum(min(b, hi) - max(a, lo)
                   for a, b, _, _ in run.trace.kernels(lo, hi)) / 1e6
    if kernel_s <= 0:
        return None
    least = sum(run.peak.least_s(c.work)[0] for c in run.calls if c.ok)
    return 100.0 * least / kernel_s
