"""h2d_pageable_bytes_per_query (program counter ``h2d_pageable_bytes``;
the engine's host path): bytes of host (numpy) arrays the program handed
to the device in the traced window, each a pageable copy on the card: the
staged chunks, ``CorpusIndex.subset``'s documents, the prune stage's
uploads and ``one_to_many``'s inputs and support; per query answered
there."""
from bench.wmdbench import spans

instrument = spans.enable


def read(run):
    rec = spans.records()
    q = spans.answered(run.trace)
    if rec is None or not q or "h2d_pageable_bytes" not in rec.counters:
        return None
    return rec.counters["h2d_pageable_bytes"] / q
