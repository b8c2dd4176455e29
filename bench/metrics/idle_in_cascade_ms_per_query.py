"""idle_in_cascade_ms_per_query (program spans; the cascade): device-idle
time of the traced window inside the self time of the cascade's host
stages (``wmd.cascade.probe``, ``.seed``, ``.first``, ``.keep``: the IVF
probe, the seed walk of ``CascadePruner.seed_candidates``, the first-stage
bounds and the seed pick, the threshold and the cluster and dense keep
with ``cluster_members``), per query answered there
(``wmdbench.spans``)."""
from bench.wmdbench import spans

CASCADE = ("wmd.cascade.probe", "wmd.cascade.seed", "wmd.cascade.first",
           "wmd.cascade.keep")

instrument = spans.enable


def read(run):
    return spans.idle_ms_per_query(run, CASCADE)
