"""Exact EMD via linear programming — test oracle only (scipy, host-side;
port of ``repro.core.exact_ot``).

Cuturi'13 proves the Sinkhorn distance converges to the exact optimal
transport distance as lambda grows; tests use this to validate the
solvers end to end rather than only against each other.
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import linprog


def exact_emd(r: np.ndarray, c: np.ndarray, m: np.ndarray) -> float:
    """min <P, M> s.t. P 1 = r, P^T 1 = c, P >= 0.

    ``r`` (a,), ``c`` (b,), ``m`` (a, b). Returns the optimal cost.
    """
    r = np.asarray(r, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    m = np.asarray(m, dtype=np.float64)
    a, b = m.shape
    # equality constraints: row sums == r, col sums == c (drop one redundant)
    a_eq = np.zeros((a + b - 1, a * b))
    for i in range(a):
        a_eq[i, i * b:(i + 1) * b] = 1.0
    for j in range(b - 1):
        a_eq[a + j, j::b] = 1.0
    b_eq = np.concatenate([r, c[:-1]])
    res = linprog(m.reshape(-1), A_eq=a_eq, b_eq=b_eq, bounds=(0, None),
                  method="highs")
    if not res.success:
        raise RuntimeError(f"linprog failed: {res.message}")
    return float(res.fun)
