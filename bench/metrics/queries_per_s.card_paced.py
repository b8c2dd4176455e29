"""queries_per_s.card_paced: ``queries_per_s`` (``queries_per_s.py``) in
the cells the card paces. Their runs spread far less than those of the
cells the host paces, so the metric has a bound of its own."""
from bench.wmdbench.cell import metric_reader

_base = metric_reader("queries_per_s")
read = _base.read
