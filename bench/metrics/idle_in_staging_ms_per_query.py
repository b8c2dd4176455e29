"""idle_in_staging_ms_per_query (program spans; the engine's host path):
device-idle time of the traced window inside the self time of the
program's staging spans (``wmd.plan``, ``wmd.stage``, ``wmd.one.stage``:
``WmdEngine._plan``, ``_prep_chunk``, ``one_to_many``'s upload and support
selection), per query answered there (``wmdbench.spans``)."""
from bench.wmdbench import spans

instrument = spans.enable


def read(run):
    return spans.idle_ms_per_query(run, spans.STAGING)
