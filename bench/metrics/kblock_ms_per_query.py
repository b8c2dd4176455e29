"""kblock_ms_per_query (device trace; the K block): device time of every
kernel launched inside ``WmdEngine._kq`` (the stacked distance GEMM and
its elementwise sqrt/exp or log-K lines, ``core/index.py``
``_compute_kq``), per query, in the traced window. The benchmark wraps
that method in a ``bench.kblock`` span for the traced window only; an
engine without it leaves the metric out."""
METHOD = "_kq"
SPAN = "bench.kblock"


def instrument(system):
    engine = getattr(system, "engine", None)
    inner = getattr(engine, METHOD, None)
    if inner is None:
        return
    from torch.profiler import record_function

    def spanned(*args, **kwargs):
        with record_function(SPAN):
            return inner(*args, **kwargs)
    setattr(engine, METHOD, spanned)


def read(run):
    tr = run.trace
    count, dev_us = tr.spans.get(SPAN, (0, 0.0))
    q = sum(len(c.positions) for c in tr.calls if c.answers is not None)
    if not count or not q or dev_us <= 0:
        return None
    return dev_us / 1e3 / q
