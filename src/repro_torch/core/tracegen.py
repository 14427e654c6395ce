"""Request-stream generation for the live serve driver (copy of
``poisson_arrivals`` from the JAX package's ``core/tracegen.py``, so both
packages draw identical streams from the same ``random.Random``)."""
from __future__ import annotations

import random
from typing import List


def poisson_arrivals(rps: float, duration: float, rng: random.Random) -> List[float]:
    """Poisson arrival times over [0, duration); an idle stream still gets
    one probe request."""
    times: List[float] = []
    t = rng.expovariate(rps)
    while t < duration:
        times.append(t)
        t += rng.expovariate(rps)
    if not times:
        times.append(rng.uniform(0.0, duration))
    return times
