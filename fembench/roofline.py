"""The yardstick of the kernels' rooflines: the card's published peaks and
the bytes a kernel's work needs, counted from the shapes (each input read
once from HBM, each output written once), whatever implements the work.

Peak: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit),
3.35 TB/s of HBM3.  Both kernels here are bound by bytes: at 67 TFLOP/s
of float32 their operations take under a tenth of their bytes' time.
The byte counts are those of the port's own kernel table (a frozen copy
of ``chip_smoke.py``'s), checked by ``fembench/tests``.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32 = 4


def bound_s(nbytes: float) -> float:
    """The least time the card needs to move ``nbytes``."""
    return nbytes / HBM_BYTES_PER_S


def lbfgs_history_bytes(m: int, p: int) -> dict:
    """One compact L-BFGS update's two passes over its [2m, P] float32
    history: the dots SY [y, s, g] (reads SY, y, s, g, writes [2m, 3]) and
    the combination gamma g + coef SY (reads SY, g, coef, gamma, writes
    [P])."""
    return {"dots": F32 * (2 * m * p + 3 * p + 6 * m),
            "combine": F32 * (2 * m * p + 2 * p + 2 * m + 1)}


def stencil_vg_bytes(nx: int, ny: int, mask_arrays: int) -> int:
    """One value-and-grad of the lattice stencil on an nx-by-ny node
    lattice: reads the [N, 4] float32 node table and ``mask_arrays``
    [nx-1, ny-1] float32 quad masks (diagonal choice, triangle presence),
    writes the [N, 4] gradient and the energy."""
    n = nx * ny
    quads = (nx - 1) * (ny - 1)
    return 2 * 4 * F32 * n + mask_arrays * F32 * quads + F32


def share(run, family: str, kernels) -> float | None:
    """100 x the least time of the traced solves' work of ``family`` (its
    bytes in ``run.work``) over the device time of ``kernels`` (short
    names) in the trace; None where either is missing."""
    nbytes = run.work.get(family)
    seconds = run.trace.kernel_seconds(kernels)
    if not nbytes or seconds <= 0:
        return None
    return 100.0 * bound_s(nbytes) / seconds
