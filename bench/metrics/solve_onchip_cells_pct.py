"""solve_onchip_cells_pct (program spans; the solve): the share of K1's
live cells past 64 x 64 solved with their tile in shared memory, over
every ``wmd.solve`` span (``WmdEngine._solve_group``) of the traced
window: 100 * the sum of its ``onchip_cells`` over the sum of its
``wide_cells`` (each span counts its pairs' live cells, its queries' words
times its documents' live words, where the launch's tile is past 64 x 64,
and the part whose live tile the live-tile kernel holds in shared memory;
the rest it streams from device memory). Nothing where no span carries
the counts (a program without them) or none met a tile past 64 x 64."""
from bench.wmdbench import spans

instrument = spans.enable


def read(run):
    rec = spans.records()
    if rec is None:
        return None
    wide = onchip = 0
    for s in rec.spans:
        if s.name == "wmd.solve" and "wide_cells" in s.attrs:
            wide += s.attrs["wide_cells"]
            onchip += s.attrs["onchip_cells"]
    return 100.0 * onchip / wide if wide else None
