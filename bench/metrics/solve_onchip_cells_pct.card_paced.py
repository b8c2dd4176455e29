"""solve_onchip_cells_pct.card_paced: ``solve_onchip_cells_pct``
(``solve_onchip_cells_pct.py``) in the cells the card paces, where it
moves ``queries_per_s.card_paced``."""
from bench.wmdbench.cell import metric_reader

_base = metric_reader("solve_onchip_cells_pct")
read = _base.read
instrument = _base.instrument
