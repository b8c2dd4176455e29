"""WMD request stream (port of ``repro.data.pipeline.wmd_request_stream``;
the LM token pipeline there is not ported yet)."""
from __future__ import annotations

import numpy as np


def wmd_request_stream(corpus, seed: int = 0):
    """Batched WMD serving requests: yields full-vocab query histograms
    drawn from the corpus query set (:func:`.corpus.make_corpus`)."""
    rng = np.random.default_rng(seed)
    n = corpus.queries.shape[0]
    while True:
        yield corpus.queries[rng.integers(0, n)]
