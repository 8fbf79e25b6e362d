"""gcups: the DP cells of the calls completed in the window, as the user
asked for them (padding never counts), over the window's wall time (first
call's entry to the last call's answer), in 1e9 a second."""


def value(run):
    cells = sum(c.work.cells for c in run.calls if c.ok)
    return cells / run.window_s / 1e9 if cells else None
