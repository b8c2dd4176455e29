"""queries_per_s (host clock): queries answered in the measured window
over the window's seconds (first call's start to last call's end). A
query counts only where its call completed."""
from bench.wmdbench.window import span


def read(run):
    done = sum(len(c.positions) for c in run.calls if c.answers is not None)
    s = span(run.calls)
    return done / s if s > 0 else None
