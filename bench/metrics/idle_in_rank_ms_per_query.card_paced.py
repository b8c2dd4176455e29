"""idle_in_rank_ms_per_query.card_paced: ``idle_in_rank_ms_per_query``
(``idle_in_rank_ms_per_query.py``) in the cells the card paces, where it
moves ``queries_per_s.card_paced``."""
from bench.wmdbench.cell import metric_reader

_base = metric_reader("idle_in_rank_ms_per_query")
read = _base.read
instrument = _base.instrument
