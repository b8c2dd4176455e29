"""solve_roofline.card_paced: ``solve_roofline`` (``solve_roofline.py``) in
the cells the card paces, where it moves ``queries_per_s.card_paced``."""
from bench.wmdbench.cell import metric_reader

_base = metric_reader("solve_roofline")
read = _base.read
instrument = _base.instrument
