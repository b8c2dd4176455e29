"""device_idle_pct.card_paced: ``device_idle_pct`` (``device_idle_pct.py``)
in the cells the card paces, where it moves
``queries_per_s.card_paced``."""
from bench.wmdbench.cell import metric_reader

_base = metric_reader("device_idle_pct")
read = _base.read
