"""The bytes of one whole-table value-and-grad of the banded energy (K4,
``banded_vg_kernel`` in ``csrc/banded_energy.cu``), counted from the
recompute tables' shapes, each input read once and each output written
once, whatever implements the work: the [N, 4] float32 node table read
and its [N, 4] gradient written, the node-window starts and the
window-relative rows, the ownership intervals, the incidence slots (int32
each), and the energy.  The port's kernel table (PERF.md) gives 32.73 MB
for the 898K plate's paired tables; ``fembench/roofline.py`` has the
card's rate.
"""

from __future__ import annotations

import math

F32 = I32 = 4
TABLES = ("re_nstarts", "re_conn_rel", "re_own_lo", "re_own_hi",
          "re_inc_rel")


def banded_vg_bytes(n_nodes: int, shapes: dict) -> int:
    """``shapes``: each of ``TABLES`` by its shape."""
    return (2 * 4 * F32 * n_nodes
            + I32 * sum(math.prod(shapes[k]) for k in TABLES) + F32)


def shapes_of(ba) -> dict:
    """The shapes of a ``BandedAssembly``'s recompute tables."""
    return {k: tuple(getattr(ba, k).shape) for k in TABLES}
