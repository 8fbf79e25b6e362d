"""pipe_wait_pct: the share of the traced window in which rank 0's card
ran NCCL's collective kernels for the pipeline's merge and verdict, in %:
rank 0 waiting there for the other ranks, which fill their blocks of the
wavefront after it (the pipeline's fill and drain), while NCCL's kernel
spins on its card.

A kernel is charged to the program's span ``swtpu.pipe.merge`` or
``swtpu.pipe.agree`` (``harness/spans.py`` maps them onto the trace's
clock) that its interval ends inside: each of those spans fetches what its
all-reduces give, so it stays open until they have run. The halo's
point-to-point kernels (NCCL's ``SendRecv``) are left out: they are the
``swtpu.pipe.halo`` span's, enqueued before the merge but run on the card
while its fetch waits. Nothing to read where the program keeps no such
spans."""

from benchmarks.harness.spans import mapped

SPANS = ("swtpu.pipe.merge", "swtpu.pipe.agree")


def value(run):
    got = mapped(run)
    if got is None:
        return None
    spans = sorted((a, b) for a, b, name, _ in got[0] if name in SPANS)
    if not spans:
        return None
    lo, hi = run.trace.window
    waited = 0.0
    for a, b, name, _ in run.trace.kernels(lo, hi):
        if "nccl" not in name.lower() or "SendRecv" in name:
            continue
        if any(s0 <= b <= s1 for s0, s1 in spans):
            waited += min(b, hi) - max(a, lo)
    return 100.0 * waited / (hi - lo)
