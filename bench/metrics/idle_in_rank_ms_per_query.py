"""idle_in_rank_ms_per_query (program spans; the engine's host path):
device-idle time of the traced window inside the self time of the
program's result spans (``wmd.collect``: ``query_batch``'s NaN checks and
assembly; ``wmd.rank``: ``search``'s host argsorts), per query answered
there (``wmdbench.spans``)."""
from bench.wmdbench import spans

instrument = spans.enable


def read(run):
    return spans.idle_ms_per_query(run, spans.RANK)
