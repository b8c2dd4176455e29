"""The closed loop: one client sends the next batch of pool queries as soon
as the previous call has returned its host result."""
from __future__ import annotations

import time
from typing import NamedTuple


class Call(NamedTuple):
    t0: float               # host clock, s
    t1: float
    positions: tuple        # pool positions of the call's queries
    answers: object         # the entry's host result, None if it raised
    error: str | None


def positions(start: int, batch: int, pool_size: int) -> tuple:
    """``batch`` pool positions from ``start`` on, in order (the pool is
    walked again from its start once it is used up)."""
    return tuple((start + i) % pool_size for i in range(batch))


def run_calls(system, batch: int, pool_size: int, seconds: float,
              start: int = 0, profile_span=None) -> list:
    """Calls for ``seconds`` of host time: a call that starts inside the
    window runs to its end. An exception inside a call fails that call's
    queries and the loop goes on. ``profile_span`` (a context-manager
    factory) wraps each call when the window is traced."""
    calls = []
    pos = start
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < seconds:
        p = positions(pos, batch, pool_size)
        pos += batch
        rows = system.rows(p)
        err = None
        t0 = time.perf_counter()
        try:
            if profile_span is None:
                ans = system.call(rows)
            else:
                with profile_span("bench.call"):
                    ans = system.call(rows)
        except Exception as e:          # a failed call fails its queries
            ans, err = None, f"{type(e).__name__}: {e}"
        t1 = time.perf_counter()
        calls.append(Call(t0=t0, t1=t1, positions=p, answers=ans,
                          error=err))
    return calls


def span(calls: list) -> float:
    """Seconds from the first call's start to the last call's end."""
    return calls[-1].t1 - calls[0].t0 if calls else 0.0
