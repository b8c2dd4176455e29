"""cdist_roofline (device trace; the one-query K block, K3 in
``csrc/cdist_exp.cu``): the least time the traced queries' distances to
every vocabulary word need, K written out (``wmdbench.roofline.cdist``),
over K3's device time."""
from bench.wmdbench import roofline

PATTERNS = ("cdist_exp_kernel",)


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
            for p in c.positions:
                work = work + roofline.cdist(int(sizes[p]), cfg["vocab_size"],
                                             cfg["embed_dim"], k_out=True)
    return 100.0 * work.seconds() / t
