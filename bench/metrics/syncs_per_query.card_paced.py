"""syncs_per_query.card_paced: ``syncs_per_query`` (``syncs_per_query.py``)
in the cells the card paces, where it moves
``queries_per_s.card_paced``."""
from bench.wmdbench.cell import metric_reader

_base = metric_reader("syncs_per_query")
read = _base.read
