"""launches_per_query (device trace; the engine's host path): kernel
launches the host made in the traced window (``cudaLaunchKernel``,
``cuLaunchKernel`` and their Ex forms) per query answered there."""
from bench.wmdbench.profile import LAUNCH_CALLS


def read(run):
    tr = run.trace
    q = sum(len(c.positions) for c in tr.calls if c.answers is not None)
    n = sum(tr.runtime.get(k, 0) for k in LAUNCH_CALLS)
    return n / q if q and n else None
