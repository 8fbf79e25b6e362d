"""setup_s: process start to the first timed call: CUDA's start, the
kernel libraries' load (and build, in a checkout's first run), the inputs
made from the seed, and one warm call of every shape the window uses."""


def value(run):
    return run.setup_s
