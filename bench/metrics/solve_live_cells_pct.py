"""solve_live_cells_pct (program spans; the solve): K1's useful (query
word, document word) cells over the cells it ran, over every ``wmd.solve``
span (``WmdEngine._solve_group``) of the traced window. Useful: the live
query words of the span's ``wmd.chunk`` times the live words of the
documents it met; ran: the chunk's padded queries times its staged width
times the group's padded documents times its width."""
from bench.wmdbench import spans

instrument = spans.enable


def read(run):
    rec = spans.records()
    if rec is None:
        return None
    by_id = {s.id: s for s in rec.spans}
    useful = ran = 0
    for s in rec.spans:
        if s.name != "wmd.solve":
            continue
        c = by_id.get(s.parent)
        while c is not None and c.name != "wmd.chunk":
            c = by_id.get(c.parent)
        if c is None:
            continue
        useful += c.attrs["query_words"] * s.attrs["doc_words"]
        ran += c.attrs["qp"] * c.attrs["width"] * s.attrs["n_pad"] \
            * s.attrs["l_g"]
    return 100.0 * useful / ran if ran else None
