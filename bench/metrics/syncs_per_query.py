"""syncs_per_query (device trace; the engine's host path): stream, device
and event synchronisations the host made in the traced window per query
answered there."""
from bench.wmdbench.profile import LAUNCH_CALLS, SYNC_CALLS


def read(run):
    tr = run.trace
    q = sum(len(c.positions) for c in tr.calls if c.answers is not None)
    if not q or not sum(tr.runtime.get(k, 0) for k in LAUNCH_CALLS):
        return None                     # no runtime calls traced
    return sum(tr.runtime.get(k, 0) for k in SYNC_CALLS) / q
