"""rwmd_roofline (device trace; the RWMD bound, K2 in
``csrc/rwmd_min_cdist.cu``): the least time the bound of every traced
query word against every vocabulary word needs
(``wmdbench.roofline.rwmd``) over K2's device time."""
from bench.wmdbench import roofline

PATTERNS = ("rwmd_min_cdist",)


def read(run):
    tr = run.trace
    t = tr.kernel_us(PATTERNS) / 1e6
    if t <= 0:
        return None
    cfg = run.cell.config
    sizes = run.corpus.pool.sizes()
    work = roofline.ZERO
    for c in tr.calls:
        if c.answers is not None:
            work = work + roofline.rwmd([int(sizes[p]) for p in c.positions],
                                        cfg["vocab_size"], cfg["embed_dim"])
    return 100.0 * work.seconds() / t
