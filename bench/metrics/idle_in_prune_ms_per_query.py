"""idle_in_prune_ms_per_query (program spans; pruning): device-idle time of
the traced window inside the self time of the prune stage's spans
(``wmd.bound``, ``wmd.prune``, ``wmd.subset``: the bounds' enqueue, the
seed pick, threshold and survivor set of ``WmdEngine._prune_full``, and
``CorpusIndex.subset``), per query answered there (``wmdbench.spans``)."""
from bench.wmdbench import spans

instrument = spans.enable


def read(run):
    return spans.idle_ms_per_query(run, spans.PRUNE)
