"""rwmd_subset_roofline (device trace; the RWMD bound over candidates, K2s
in ``csrc/rwmd_min_cdist.cu``): the least time the bounds of the traced
window's ``wmd.cascade.rwmd`` spans need (:func:`work`, from each span's
``rows``, ``vc`` and ``queries``) over the device time of the kernels
named ``rwmd_min_cdist``, which in a cascade cell are K2s's alone."""
from bench.wmdbench import roofline, spans

PATTERNS = ("rwmd_min_cdist",)

instrument = spans.enable


def work(rows: int, vc: int, queries: int, w: int) -> roofline.Work:
    """The RWMD bound of ``rows`` live query words, of ``queries``
    queries, over a candidate vocabulary of ``vc`` words at width ``w``:
    per (row, word) a w-long dot product, |a|^2 + |b|^2 - 2ab, the square
    root and the min over the query's rows (2w + 5). Bytes: the candidate
    words' and the queries' rows once, one (vc,) row out per query."""
    flops = float(rows) * vc * (2 * w + 5)
    nbytes = 4.0 * (vc * w + rows * w) + 4.0 * queries * vc
    return roofline.Work(flops, nbytes)


def read(run):
    tr, rec = run.trace, spans.records()
    if tr is None or rec is None:
        return None
    t = tr.kernel_us(PATTERNS) / 1e6
    w = run.cell.config["embed_dim"]
    total = roofline.ZERO
    for s in rec.spans:
        a = s.attrs
        if s.name == "wmd.cascade.rwmd" and "rows" in a:
            total = total + work(a["rows"], a["vc"], a["queries"], w)
    if t <= 0 or total.flops <= 0:
        return None
    return 100.0 * total.seconds() / t
