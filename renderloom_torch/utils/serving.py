"""Batched-serving batch planner.

A copy of the JAX package's ``renderloom/utils/serving.py`` (which
imports no JAX; the port keeps its own copy).  A serving program runs at
a fixed clip-batch size (one ``torch.export`` artifact per size,
``renderloom_torch.eval.export``), and measured throughput is not
guaranteed monotone in the batch size: a 2-clip program can run slower
than two 1-clip ones.  So the serving layer plans
each request as a multiset of PROFILED batch sizes — running a request
of 2 as two 1-clip programs, or padding 6 clips into the 8-clip program
when that is measured faster than any exact split — which makes served
throughput monotone in the request size by construction and reuses only
profiled programs.  ``chip_smoke.py``'s phase Y profiles the port's
sizes on the card.
"""

from __future__ import annotations

from typing import Dict, List, Tuple


def plan_chunks(n: int, times_ms: Dict[int, float]) -> List[int]:
    """Cheapest multiset of profiled batch sizes covering ``n`` clips.

    ``times_ms`` maps batch size → measured ms per batch of that size.
    Exact dynamic program over cost(r) = min_s times[s] + cost(r − s)
    (sizes may repeat; a chunk may overshoot the remainder — the extra
    slots run padding clips, which is frequently optimal: e.g. with the
    table {1: 335, 2: 703, 4: 1089, 8: 1452}, n=6 plans [8] at 1452 ms,
    beating the exact split [4, 1, 1] at 1759 ms, and n=2 plans [1, 1]
    at 670 ms, beating the valley program's 703 ms).
    Returns chunk sizes, largest first."""
    if n <= 0:
        return []
    sizes = sorted(times_ms)
    if not sizes:
        raise ValueError("empty serving profile")
    best: List[Tuple[float, List[int]]] = [(0.0, [])]
    for r in range(1, n + 1):
        cand = min(
            ((times_ms[s] + best[max(0, r - s)][0], s) for s in sizes),
            key=lambda c: (c[0], -c[1]))
        cost, s = cand
        best.append((cost, best[max(0, r - s)][1] + [s]))
    return sorted(best[n][1], reverse=True)


def planned_ms(n: int, times_ms: Dict[int, float]) -> float:
    """Total planned ms for ``n`` clips under :func:`plan_chunks`."""
    return sum(times_ms[s] for s in plan_chunks(n, times_ms))
