"""solve_roofline (device trace; the solve: K1, and K4 at Q = 1, in
``csrc/sinkhorn_fused.cu``): the least time the solved (query, document)
pairs of the traced window need (``wmdbench.roofline.solve``) over the
device time of the solve's kernels.

Which documents each query was solved against is read from the engine in
the traced window: the benchmark wraps ``WmdEngine._plan`` (each query's
support size), ``_prep_chunk`` (which queries a chunk holds) and
``_solve_group`` (the documents, ``DocGroup.cols``, a chunk is solved
against), and counts, per query and call, the distinct documents it met,
their live words and their distinct words, from the benchmark's own
corpus. An engine without those methods leaves the metric out. Without an
engine (``one_to_many``) every query is solved against every document."""
import numpy as np

from bench.wmdbench import roofline

PATTERNS = ("sinkhorn_fused_",)
METHODS = ("_plan", "_prep_chunk", "_solve_group")


def instrument(system):
    engine = getattr(system, "engine", None)
    if engine is None or not all(hasattr(engine, m) for m in METHODS) \
            or not hasattr(engine.index, "to_external"):
        return
    plan, prep, solve = (getattr(engine, m) for m in METHODS)
    call = system.call
    v_of, chunk_of, log = {}, {}, []

    def plan_(queries, *a, **kw):
        out = plan(queries, *a, **kw)
        v_of.update({id(q): v for q, v in zip(queries, out[0])})
        return out

    def prep_(chunk_queries, *a, **kw):
        out = prep(chunk_queries, *a, **kw)
        chunk_of[id(out[1])] = (out[1], [v_of[id(q)]
                                         for q in chunk_queries])
        return out

    def solve_(kq, r, mask, grp, *a, **kw):
        log[-1].append((id(r), chunk_of[id(r)][1], np.asarray(grp.cols)))
        return solve(kq, r, mask, grp, *a, **kw)

    def call_(rows):
        v_of.clear()
        chunk_of.clear()
        log.append([])
        return call(rows)

    engine._plan, engine._prep_chunk, engine._solve_group = \
        plan_, prep_, solve_
    system.call = call_
    system.solve_log = log


def _words_of(docs, ptr, sizes, ids):
    """The word ids of documents ``docs`` (CSR rows), concatenated."""
    n = sizes[docs]
    at = np.repeat(ptr[docs] - np.cumsum(n) + n, n) + np.arange(n.sum())
    return ids[at]


def _work_per_call(log, to_external, corpus, n_iter):
    """Work of each call: per chunk, the union of the documents it was
    solved against and its queries' sizes; the documents' words once."""
    sizes = corpus.docs.sizes()
    ptr, ids = corpus.docs.ptr, corpus.docs.ids
    distinct_of = {}
    work = roofline.ZERO
    for entries in log:
        chunks = {}
        for key, v, cols in entries:
            chunks.setdefault(key, (v, []))[1].append(cols)
        seen = []
        for v, cols in chunks.values():
            docs = np.unique(to_external(np.concatenate(cols)))
            seen.append(docs)
            words = float(sizes[docs].sum())
            key = hash(docs.tobytes())
            if key not in distinct_of:
                distinct_of[key] = float(np.unique(
                    _words_of(docs, ptr, sizes, ids)).size)
            for vq in v:
                work = work + roofline.solve(int(vq), docs.size, words,
                                             distinct_of[key], n_iter)
        if seen:
            work = work + roofline.doc_words(
                float(sizes[np.unique(np.concatenate(seen))].sum()))
    return work


def read(run):
    tr = run.trace
    t = tr.kernel_us(PATTERNS) / 1e6
    if t <= 0:
        return None
    corpus = run.corpus
    n_iter = int(run.cell.traffic.get("n_iter", run.cell.config["n_iter"]))
    if getattr(run.system, "engine", None) is not None:
        log = [e for e in getattr(run.system, "solve_log", []) if e]
        if not log:
            return None
        work = _work_per_call(log, run.system.engine.index.to_external,
                              corpus, n_iter)
        return 100.0 * work.seconds() / t
    n_docs = corpus.idx.shape[0]
    words = float(corpus.docs.ids.size)
    distinct = float(np.unique(corpus.docs.ids).size)
    sizes = corpus.pool.sizes()
    work = roofline.ZERO
    for c in tr.calls:
        if c.answers is None:
            continue
        work = work + roofline.doc_words(words)
        for p in c.positions:
            work = work + roofline.solve(int(sizes[p]), n_docs, words,
                                         distinct, n_iter)
    return 100.0 * work.seconds() / t
