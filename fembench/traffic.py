"""The one generator of load cases, read from a traffic file.

A traffic file gives ``pool``: the number of distinct load cases, and
``load``: ``magnitude_n`` [lo, hi] (the traction's resultant on the
loaded face, N) and ``angle_deg`` [lo, hi] (its direction from the x
axis).  The pool is the same for every seed: magnitudes and angles at the
midpoints of ``pool`` equal strata of their ranges, the k-th magnitude
paired with the (7 k mod pool)-th angle.  A seed permutes the pool (a new
permutation every pass) and draws each solve's ``u0_seed``, so every
seed runs the same set of solves, in its own order.  Warm-up cases come
from their own stream.
"""

from __future__ import annotations

import math

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2 ** 64, *stream]))


def pool(traffic: dict) -> list:
    n = int(traffic["pool"])
    load = traffic["load"]
    mid = (np.arange(n) + 0.5) / n

    def strata(lo_hi):
        lo, hi = (float(v) for v in lo_hi)
        return lo + mid * (hi - lo)

    mags = strata(load["magnitude_n"])
    angles = strata(load["angle_deg"])
    return [(float(mags[k]), float(angles[(7 * k) % n])) for k in range(n)]


def _case(index: int, mag: float, angle: float, seed: int, stream: int):
    a = math.radians(angle)
    u0_seed = int(_rng(seed, stream, index).integers(0, 2 ** 63))
    return {"index": index, "magnitude": mag, "angle_deg": angle,
            "traction": (mag * math.cos(a), mag * math.sin(a)),
            "u0_seed": u0_seed}


def load_cases(traffic: dict, seed: int):
    """The window's load cases, without end."""
    cases = pool(traffic)
    order = _rng(seed, 0)
    i = 0
    while True:
        for k in order.permutation(len(cases)):
            yield _case(i, *cases[k], seed, 1)
            i += 1


def warmup_cases(traffic: dict, seed: int) -> list:
    cases = pool(traffic)
    n = int(traffic["warmup_solves"])
    picks = _rng(seed, 2).permutation(len(cases))
    return [_case(i, *cases[picks[i % len(cases)]], seed, 3)
            for i in range(n)]


def sampled(traffic: dict, seed: int):
    """Whether each solve of the window (in order) is checked: the first
    always, then each with the traffic file's ``check_fraction``, drawn
    from the seed."""
    draw = _rng(seed, 4)
    p = float(traffic["check_fraction"])
    yield True
    while True:
        yield bool(draw.random() < p)
