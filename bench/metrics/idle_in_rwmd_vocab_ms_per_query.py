"""idle_in_rwmd_vocab_ms_per_query (program spans; the cascade):
device-idle time of the traced window inside the self time of
``wmd.cascade.vocab`` (``CascadePruner._rwmd_vocab``'s host staging of
the RWMD stage's candidate vocabulary and ``_upload_prep``'s uploads),
per query answered there (``wmdbench.spans``)."""
from bench.wmdbench import spans

VOCAB = ("wmd.cascade.vocab",)

instrument = spans.enable


def read(run):
    return spans.idle_ms_per_query(run, VOCAB)
