"""call_p95_ms.host_paced (host clock; a call as the host sees it): the
95th percentile of the wall time of every call in the measured window of
a traced run, where the card idles most of the window."""
import numpy as np


def read(run):
    t = [c.t1 - c.t0 for c in run.calls]
    return float(np.percentile(t, 95)) * 1e3 if t else None
