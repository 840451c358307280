"""Optimizers on a flat parameter vector (port of
``hidenn_fem_tpu/solve/optimizers.py``): compact L-BFGS
(``scale_by_compact_lbfgs``, ``lbfgs(linesearch="none")``), optax's
two-loop L-BFGS (``lbfgs(mode="scan")``) and its zoom line search
(``lbfgs(linesearch="zoom")``, rewritten here: optax imports JAX), and
Adam (``adam``, ``adam_per_group``, ``freeze_groups``).

An optimizer here is an object with ``init(x, like=None) -> state`` and
``update(g, state, x) -> (step, state)`` on flat [P] vectors; the driver
applies ``x + step``.  Parameters are flattened in ``ravel_pytree`` order
(sorted keys: ``coords`` then ``u``) by ``ravel_params``; a bare tensor
(the [N, 4] node table of the node-space solves) is its own flat view.
``like`` is the params template the flat vector came from (a dict of
tensors, or a bare tensor): the optax transformations that label
parameter groups by top-level key (``multi_transform``) see the pytree,
and the flat interface needs it to find a group's entries.  L-BFGS
ignores it.

The direction H g comes from the compact representation (Byrd, Nocedal &
Schnabel 1994, Thm 2.2):

    H g = gamma g + [S  gamma Y] M [S^T g; gamma Y^T g],
    M   = [[R^{-T} (D + gamma Y^T Y) R^{-1},  -R^{-T}],
           [-R^{-1},                           0     ]],

with R = triu(S^T Y) and D = diag(S^T Y): two [2m, P] matrix products
and two m-by-m triangular solves per step.  On the card the two
products are the kernels of ``ops/lbfgs_history.py`` (the dots
SY [y, s, g] and the combination gamma g + coef^T SY, one pass over the
history each); on the CPU their plain versions, the JAX package's
expressions.  ``update`` writes the new pair into the state's history
tensors in place (the [2m, P] history is the solve's largest buffer:
1.48 GB at the 922K-class plate, m = 100 and P = 1,848,964 float32), so a
state is consumed by the update that takes it.  The (s, y) pair goes to slot
(count-1) % m and is zero on the first call; gamma is s.y / y.y of the
newest pair, or min(1, 1/|g|) on the first call (gamma is 1 throughout
with ``scale_init_precond=False``); a pair with s.y <= 1e-10
(torch LBFGS's curvature guard) is stored as zeros, its R diagonal is
patched to 1 and gamma keeps its last accepted value.  The products run
in full float32: TF32 is off package-wide (``hidenn_fem_tpu_torch``).

Capture.  ``CompactLBFGS``, ``TwoLoopLBFGS``, ``Adam`` and
``FreezeGroups`` say ``capturable = True``: after their first call, an
``update`` is safe to record in a CUDA graph and replay (the drivers do,
``solve/drivers.py``).  Their states hold two counts: ``count``, a host
integer (branched on only for the first call, and kept for checkpoints),
and ``device_count``, the same count as an int64 tensor on the params'
device, from which every history slot and order and Adam's bias
corrections are taken.  Every state tensor is a buffer updated in place
(``copy_``, ``index_copy_``), so the tensors of a state stay the same
objects from call to call; ``advance(state, n)`` adds ``n`` replayed
calls to the host count.  ``ZoomLBFGS`` reads every trial point on the
host and is not capturable.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.lbfgs_history import history_combine, history_dots

__all__ = ["CompactLBFGSState", "CompactLBFGS", "scale_by_compact_lbfgs",
           "lbfgs", "adam", "adam_per_group", "freeze_groups", "AdamState",
           "Adam", "FreezeGroups", "ravel_params", "unravel_params",
           "LBFGSState", "TwoLoopLBFGS", "ZoomLinesearchInfo",
           "ZoomLinesearchState", "ZoomLBFGSState", "ZoomLBFGS"]


def ravel_params(params) -> torch.Tensor:
    """Flat [P] vector of a params dict, keys in sorted order, or of a
    bare tensor."""
    if isinstance(params, torch.Tensor):
        return params.reshape(-1)
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def unravel_params(flat: torch.Tensor, like):
    """Inverse of ``ravel_params``: views of ``flat`` shaped as ``like``
    (a dict, or a bare tensor)."""
    if isinstance(like, torch.Tensor):
        return flat.view(like.shape)
    out, i = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[i:i + n].view(like[k].shape)
        i += n
    return out


class CompactLBFGSState(NamedTuple):
    count: int                 # update calls so far
    device_count: torch.Tensor  # the same count, int64 on the device
    prev_flat: torch.Tensor    # [P] previous flat params
    prev_grad: torch.Tensor    # [P] previous flat gradient
    SY: torch.Tensor           # [2m, P]: rows 0..m-1 = s_i, m..2m-1 = y_i
    STY: torch.Tensor          # [m, m]: s_i . y_j
    YTY: torch.Tensor          # [m, m]: y_i . y_j
    gamma: torch.Tensor        # last accepted identity scale


def _advance(state, n: int):
    """``state`` with ``n`` more calls on its host count (replays)."""
    return state._replace(count=state.count + n)


def _device_count(x: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int64, device=x.device)


class CompactLBFGS:
    """The L-BFGS direction H g (``scale_by_compact_lbfgs``), optionally
    followed by a fixed step ``-learning_rate * H g``."""

    capturable = True

    def __init__(self, memory_size: int = 100,
                 learning_rate: float | None = None,
                 scale_init_precond: bool = True):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size
        self.learning_rate = learning_rate
        self.scale_init_precond = scale_init_precond

    def init(self, x: torch.Tensor, like=None) -> CompactLBFGSState:
        m, p = self.m, x.numel()

        def zeros(*shape):
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        return CompactLBFGSState(
            count=0, device_count=_device_count(x), prev_flat=zeros(p),
            prev_grad=zeros(p), SY=zeros(2 * m, p), STY=zeros(m, m),
            YTY=zeros(m, m),
            gamma=torch.ones((), dtype=x.dtype, device=x.device))

    advance = staticmethod(_advance)

    def update(self, g: torch.Tensor, state: CompactLBFGSState,
               x: torch.Tensor) -> Tuple[torch.Tensor, CompactLBFGSState]:
        m = self.m
        c = state.count
        k = state.device_count
        slot = torch.remainder(k - 1, m).view(1)
        if c == 0:
            s = torch.zeros_like(x)
            y = torch.zeros_like(g)
        else:
            s = x - state.prev_flat
            y = g - state.prev_grad
        # torch's curvature guard: reject non-positive-curvature pairs
        accept = torch.dot(s, y) > 1e-10
        s = torch.where(accept, s, 0.0)
        y = torch.where(accept, y, 0.0)
        SY = state.SY                   # history updated in place
        SY.index_copy_(0, slot, s[None])
        SY.index_copy_(0, slot + m, y[None])

        # one pass over the history: columns are (.y, .s, .g) products
        B = history_dots(SY, y, s, g)                       # [2m, 3]
        s_dot_y, u = B[:m, 0], B[:m, 2]                     # S.y, S.g
        y_dot_y, y_dot_s, v = B[m:, 0], B[m:, 1], B[m:, 2]
        STY = state.STY
        STY.index_copy_(1, slot, s_dot_y[:, None])
        STY.index_copy_(0, slot, y_dot_s[None])
        YTY = state.YTY
        YTY.index_copy_(1, slot, y_dot_y[:, None])
        YTY.index_copy_(0, slot, y_dot_y[None])

        sy = torch.dot(s, y)
        yy = torch.dot(y, y)
        if not self.scale_init_precond:
            gamma = torch.ones((), dtype=g.dtype, device=g.device)
        elif c == 0:
            # first step: the capped reciprocal gradient norm
            gnorm = torch.linalg.vector_norm(g)
            gamma = torch.clamp(1.0 / torch.where(gnorm > 0, gnorm, 1.0),
                                max=1.0)
        else:
            gamma = torch.where(accept & (yy > 0.0),
                                sy / torch.where(yy > 0, yy, 1.0),
                                state.gamma)

        # chronological (oldest-first) view of the circular buffer
        order = torch.remainder(k + torch.arange(m, device=g.device), m)
        A = STY[order][:, order]
        YY = YTY[order][:, order]
        d = torch.diagonal(A)
        # inert rows for empty / zero-curvature pairs (rho = 0 analog)
        R = torch.triu(A, diagonal=1) + torch.diag(
            torch.where(d == 0.0, 1.0, d))
        u_o = u[order]
        v_o = v[order]
        w1 = torch.linalg.solve_triangular(R, u_o[:, None],
                                           upper=True)[:, 0]
        t = d * w1 + gamma * (YY @ w1) - gamma * v_o
        w2 = torch.linalg.solve_triangular(R.T, t[:, None],
                                           upper=False)[:, 0]

        coef = torch.zeros((2 * m,), dtype=g.dtype, device=g.device)
        coef.index_copy_(0, order, w2)
        coef.index_copy_(0, order + m, -gamma * w1)
        # one pass: gamma g + coef @ SY, times -learning_rate if given
        step = history_combine(SY, g, coef, gamma,
                               1.0 if self.learning_rate is None
                               else -self.learning_rate)
        state.prev_flat.copy_(x)
        state.prev_grad.copy_(g)
        state.gamma.copy_(gamma)
        k.add_(1)
        return step, state._replace(count=c + 1)


def scale_by_compact_lbfgs(memory_size: int = 100,
                           scale_init_precond: bool = True) -> CompactLBFGS:
    """The L-BFGS direction H g (no step size, no sign); with
    ``scale_init_precond=False`` the identity scale gamma stays 1."""
    return CompactLBFGS(memory_size, scale_init_precond=scale_init_precond)


def lbfgs(memory_size: int = 100, max_linesearch_steps: int = 20,
          linesearch: str = "none", learning_rate: float = 1.0,
          mode: str = "compact"):
    """L-BFGS, matching the reference's flagship solve.

    ``linesearch="none"`` (default) is torch LBFGS's default fixed step
    (lr = ``learning_rate``, no line search); ``mode="compact"`` computes
    its direction by the compact representation (``CompactLBFGS``),
    ``mode="scan"`` by optax's two-loop recursion (``TwoLoopLBFGS``).
    ``linesearch="zoom"`` is ``optax.lbfgs(memory_size=memory_size,
    linesearch=optax.scale_by_zoom_linesearch(max_linesearch_steps))``:
    the two-loop direction and the strong-Wolfe zoom search
    (``ZoomLBFGS``; ``mode`` and ``learning_rate`` do not apply, as in the
    JAX package).  Drive it with ``run_lbfgs``, which hands the search the
    loss and reuses the value and gradient it computed."""
    if mode not in ("compact", "scan"):
        raise ValueError(f"unknown mode {mode!r}")
    if linesearch == "zoom":
        return ZoomLBFGS(memory_size, max_linesearch_steps)
    if linesearch == "none":
        if mode == "compact":
            return CompactLBFGS(memory_size, learning_rate=learning_rate)
        return TwoLoopLBFGS(memory_size, learning_rate=learning_rate)
    raise ValueError(f"unknown linesearch {linesearch!r}")


# ------------------------------------------------------ two-loop L-BFGS
class LBFGSState(NamedTuple):
    """optax's ``ScaleByLBFGSState`` on flat vectors."""
    count: int                          # update calls so far
    device_count: torch.Tensor          # the same count, int64 on device
    params: torch.Tensor                # [P] previous flat params
    updates: torch.Tensor               # [P] previous flat gradient
    diff_params_memory: torch.Tensor    # [m, P] s_i
    diff_updates_memory: torch.Tensor   # [m, P] y_i
    weights_memory: torch.Tensor        # [m] rho_i = 1 / (s_i . y_i)


class TwoLoopLBFGS:
    """optax's ``scale_by_lbfgs(memory_size, scale_init_precond=True)``:
    the two-loop recursion (Nocedal & Wright, Algorithm 7.4) over a
    circular [m, P] history, then ``-learning_rate`` times the direction
    H g (``direction`` alone gives H g).

    optax's semantics, kept exactly: the pair (s, y) goes to slot
    (count - 1) % m and is zero on the first call; rho = 1/(s.y), 0 where
    s.y == 0 (no curvature guard: a pair with s.y < 0 is kept, unlike
    ``CompactLBFGS``); gamma = s.y / y.y of the newest pair (1 when
    y.y == 0), or min(1, 1/|g|) on the first call.  2m dot products and
    2m axpys per call, in sequence, over the history's rows taken oldest
    first by one ``index_select`` of each [m, P] memory on the device
    count (a copy of both memories per call, so that the loops' row
    indices are the same on every call); the history is updated in place,
    so a state is consumed by the update that takes it."""

    capturable = True

    def __init__(self, memory_size: int = 100, learning_rate: float = 1.0):
        if memory_size < 1:
            raise ValueError("memory_size must be >= 1")
        self.m = memory_size
        self.learning_rate = learning_rate

    def init(self, x: torch.Tensor, like=None) -> LBFGSState:
        m, p = self.m, x.numel()

        def zeros(*shape):
            return torch.zeros(shape, dtype=x.dtype, device=x.device)
        return LBFGSState(
            count=0, device_count=_device_count(x), params=zeros(p),
            updates=zeros(p), diff_params_memory=zeros(m, p),
            diff_updates_memory=zeros(m, p), weights_memory=zeros(m))

    advance = staticmethod(_advance)

    def direction(self, g: torch.Tensor, state: LBFGSState,
                  x: torch.Tensor) -> Tuple[torch.Tensor, LBFGSState]:
        """(H g, new state): optax's ``scale_by_lbfgs`` update."""
        m, c, k = self.m, state.count, state.device_count
        S, Y, W = (state.diff_params_memory, state.diff_updates_memory,
                   state.weights_memory)
        prev = torch.remainder(k - 1, m).view(1)
        if c > 0:
            s = x - state.params
            y = g - state.updates
            sy = torch.dot(y, s)
            S.index_copy_(0, prev, s[None])
            Y.index_copy_(0, prev, y[None])
            W.index_copy_(0, prev, torch.where(sy == 0.0, 0.0,
                                               1.0 / sy).view(1))
            yy = torch.dot(y, y)
            gamma = torch.where(yy > 0.0, sy / yy, 1.0)
        else:
            S.index_fill_(0, prev, 0.0)
            Y.index_fill_(0, prev, 0.0)
            W.index_fill_(0, prev, 0.0)
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g), max=1.0)
        # oldest first; the first loop runs newest first
        order = torch.remainder(k + torch.arange(m, device=g.device), m)
        So, Yo, Wo = S[order], Y[order], W[order]
        vec, alphas = g, [None] * m
        for i in reversed(range(m)):
            alphas[i] = Wo[i] * torch.dot(So[i], vec)
            vec = vec + (-alphas[i]) * Yo[i]
        vec = gamma * vec
        for i in range(m):
            beta = Wo[i] * torch.dot(Yo[i], vec)
            vec = vec + (alphas[i] - beta) * So[i]
        state.params.copy_(x)
        state.updates.copy_(g)
        k.add_(1)
        return vec, state._replace(count=c + 1)

    def update(self, g: torch.Tensor, state: LBFGSState, x: torch.Tensor
               ) -> Tuple[torch.Tensor, LBFGSState]:
        hg, state = self.direction(g, state, x)
        return hg * (-self.learning_rate), state


# ------------------------------------------------------- zoom line search
class ZoomLinesearchInfo(NamedTuple):
    """optax's ``ZoomLinesearchInfo`` of the last search."""
    num_linesearch_steps: int
    decrease_error: float
    curvature_error: float


class ZoomLinesearchState(NamedTuple):
    """optax's ``ScaleByZoomLinesearchState``: the accepted step size (the
    next search's first guess), and the value and gradient at the
    accepted point (inf before the first search)."""
    learning_rate: float
    value: torch.Tensor
    grad: torch.Tensor
    info: ZoomLinesearchInfo


class ZoomLBFGSState(NamedTuple):
    lbfgs: LBFGSState
    linesearch: ZoomLinesearchState


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax's ``_cubicmin``; NaN when there is none)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + (-(db * db)) * v1) / denom
    B = ((-(dc * dc * dc)) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    D = fa
    C = fpa
    db = b - a
    B = (fb - D - C * db) / (db * db)
    return a - C / (2.0 * B)


# optax's zoom_linesearch settings under scale_by_zoom_linesearch's
# defaults, the JAX package's: tol 0, no maximal step size
_INCREASE_FACTOR = 2.0
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_STEPSIZE_PRECISION = 1e-5


def _zoom_linesearch(value_and_grad, x, d, value, grad, stepsize_guess,
                     max_linesearch_steps: int):
    """optax's ``zoom_linesearch`` along ``d`` from ``x``: the interval
    search of Nocedal & Wright's Algorithm 3.5, then the zoom of Algorithm
    3.6 (cubic, else quadratic, else bisection trial points), to the
    strong-Wolfe conditions or Hager and Zhang's approximate-Wolfe
    decrease, and optax's safeguard when the search runs out of steps or
    its interval falls below ``_STEPSIZE_PRECISION``.  The control runs
    on the host, on numpy scalars of the parameters' dtype (optax's
    scalar arithmetic); each trial point costs one
    ``value_and_grad(x + t d)`` and one read.

    Returns (step size, value, gradient, number of trial points,
    decrease error, curvature error)."""
    f = np.float64 if x.dtype == torch.float64 else np.float32
    inf = f(np.inf)

    def at(t):
        v, g = value_and_grad(x + float(t) * d)
        return f(v.item()), g, f(torch.dot(g, d).item())

    def decrease_error(t, v, sl):
        # Armijo's, or else the approximate decrease near a minimum
        e = v - value_init - _SLOPE_RTOL * t * slope_init
        a = sl - (2 * _SLOPE_RTOL - 1.0) * slope_init
        dv = v - value_init - _APPROX_DEC_RTOL * np.abs(value_init)
        e = np.maximum(np.minimum(np.maximum(a, dv), e), f(0.0))
        return inf if np.isnan(e) else e

    def curvature_error(sl):
        e = np.maximum(np.abs(sl) - _CURV_RTOL * np.abs(slope_init), f(0.0))
        return inf if np.isnan(e) else e

    value_init = f(value.item())
    slope_init = f(torch.dot(d, grad).item())
    count = 0
    stepsize, v_cur, g_cur, sl_cur = f(0.0), value_init, grad, slope_init
    dec_err = curv_err = inf
    interval_found = done = failed = False
    low = high = cubic_ref = f(0.0)
    v_low = v_high = v_cubic = value_init
    sl_low = sl_high = slope_init
    safe_t, safe_v, safe_g = f(0.0), value_init, grad
    with np.errstate(all="ignore"):
        while not (done or failed):
            if not interval_found:
                # the interval search (optax's _search_interval)
                t = stepsize_guess if count == 0 else \
                    _INCREASE_FACTOR * stepsize
                t = f(t)
                v, g, sl = at(t)
                dec_err = decrease_error(t, v, sl)
                curv_err = curvature_error(sl)
                err = np.maximum(dec_err, curv_err)
                if dec_err <= 0.0:
                    safe_t, safe_v, safe_g = t, v, g
                set_high = (dec_err > 0.0) or (v >= v_cur and count > 0)
                set_low = (sl >= 0.0) and not set_high
                if set_low:
                    low, v_low, sl_low = t, v, sl
                    high, v_high, sl_high = stepsize, v_cur, sl_cur
                else:
                    low, v_low, sl_low = stepsize, v_cur, sl_cur
                    high, v_high, sl_high = t, v, sl
                interval_found = set_high or set_low or err <= 0.0
                done = bool(err <= 0.0)
                failed = count + 1 >= max_linesearch_steps and not done
                cubic_ref, v_cubic = low, v_low
            else:
                # the zoom (optax's _zoom_into_interval)
                delta = np.abs(high - low)
                left, right = np.minimum(high, low), np.maximum(high, low)
                cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
                too_small = delta <= _STEPSIZE_PRECISION
                mc = _cubicmin(low, v_low, sl_low, high, v_high, cubic_ref,
                               v_cubic)
                mq = _quadmin(low, v_low, sl_low, high, v_high)
                if left + cubic_chk < mc < right - cubic_chk:
                    t = mc
                elif left + quad_chk < mq < right - quad_chk:
                    t = mq
                else:
                    t = (low + high) / 2.0
                t = f(t)
                v, g, sl = at(t)
                dec_err = decrease_error(t, v, sl)
                curv_err = curvature_error(sl)
                err = np.maximum(dec_err, curv_err)
                if dec_err <= 0.0 and v < safe_v:
                    safe_t, safe_v, safe_g = t, v, g
                done = bool(err <= 0.0)
                set_high_mid = (dec_err > 0.0) or (v >= v_low)
                set_high_low = (sl * (high - low) >= 0.0) and \
                    not set_high_mid
                if set_high_mid or set_high_low:
                    cubic_ref, v_cubic = high, v_high
                else:
                    cubic_ref, v_cubic = low, v_low
                if set_high_mid:
                    high, v_high, sl_high = t, v, sl
                elif set_high_low:
                    high, v_high, sl_high = low, v_low, sl_low
                if not set_high_mid:
                    low, v_low, sl_low = t, v, sl
                failed = ((count + 1 >= max_linesearch_steps
                           or (too_small and safe_t > 0.0)) and not done)
            count += 1
            stepsize, v_cur, g_cur, sl_cur = t, v, g, sl
            if failed and (safe_t > 0.0 or np.isinf(dec_err)):
                # optax's _try_safe_step: the best point with sufficient
                # decrease (or the start, when every trial left the domain)
                stepsize, v_cur, g_cur = safe_t, safe_v, safe_g
    return stepsize, v_cur, g_cur, count, dec_err, curv_err


class ZoomLBFGS:
    """``optax.lbfgs(memory_size, linesearch=optax.scale_by_zoom_linesearch(
    max_linesearch_steps))``: the two-loop direction d = -H g (optax's
    ``scale_by_lbfgs`` then ``scale(-1)``), then ``_zoom_linesearch`` along
    d from the previous accepted step size (optax's
    ``initial_guess_strategy="keep"``, 1 at the start); the step is
    ``t d``.  ``update`` needs the value at ``x`` and ``value_fn``,
    ``x -> (value, gradient)``; the state keeps the value and gradient at
    the accepted point, which ``run_lbfgs`` reuses for the next step
    (optax's ``value_and_grad_from_state``)."""

    def __init__(self, memory_size: int = 100,
                 max_linesearch_steps: int = 20):
        self.lbfgs = TwoLoopLBFGS(memory_size)
        self.max_linesearch_steps = max_linesearch_steps

    def init(self, x: torch.Tensor, like=None) -> ZoomLBFGSState:
        return ZoomLBFGSState(
            lbfgs=self.lbfgs.init(x),
            linesearch=ZoomLinesearchState(
                learning_rate=1.0,
                value=torch.full((), float("inf"), dtype=x.dtype,
                                 device=x.device),
                grad=torch.zeros_like(x),
                info=ZoomLinesearchInfo(0, float("inf"), float("inf"))))

    def update(self, g: torch.Tensor, state: ZoomLBFGSState,
               x: torch.Tensor, value=None, value_fn=None
               ) -> Tuple[torch.Tensor, ZoomLBFGSState]:
        if value is None or value_fn is None:
            raise ValueError("the zoom line search needs value= and "
                             "value_fn= (drive it with run_lbfgs)")
        hg, lstate = self.lbfgs.direction(g, state.lbfgs, x)
        d = hg * -1.0
        f = np.float64 if x.dtype == torch.float64 else np.float32
        t, v, gv, n, de, ce = _zoom_linesearch(
            value_fn, x, d, value, g, f(state.linesearch.learning_rate),
            self.max_linesearch_steps)
        return float(t) * d, ZoomLBFGSState(
            lbfgs=lstate,
            linesearch=ZoomLinesearchState(
                learning_rate=float(t),
                value=torch.full((), float(v), dtype=x.dtype,
                                 device=x.device),
                grad=gv, info=ZoomLinesearchInfo(n, float(de), float(ce))))


# ------------------------------------------------------------------ Adam
def _key_ranges(like) -> dict:
    """Top-level key -> (start, end) of its entries in the flat vector of
    ``like`` (sorted-key order, as ``ravel_params``)."""
    if not isinstance(like, dict):
        raise ValueError("parameter groups need the params dict as "
                         "``like`` (keys label the groups)")
    out, i = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = (i, i + n)
        i += n
    return out


class AdamState(NamedTuple):
    count: int                 # update calls so far
    device_count: torch.Tensor  # the same count, int64 on the device
    mu: torch.Tensor           # [P] first moment
    nu: torch.Tensor           # [P] second moment
    lr: torch.Tensor | float   # learning rate: a scalar or a [P] vector


@functools.lru_cache(maxsize=None)
def _bias_corrections(b: float, dtype: torch.dtype, device: torch.device
                      ) -> torch.Tensor:
    """optax's bias correction ``1 - b**count`` for count = 0, 1, ..., in
    the moments' numpy precision, as the host computes it one count at a
    time, on ``device``: the table ends at the first count where it is
    exactly 1, which it stays for every later count (so a lookup clamps
    its index to the end).  Entry 0 (no call yet) is never read."""
    f = np.float64 if dtype == torch.float64 else np.float32
    out = [f(0)]
    while out[-1] != f(1):
        out.append(f(1) - f(b) ** f(len(out)))
    return torch.tensor(np.asarray(out, dtype=f), dtype=dtype,
                        device=device)


class Adam:
    """optax's ``adam``: b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
    bias-corrected moments, step ``-lr * mu_hat / (sqrt(nu_hat) + eps)``
    in optax's order of operations.  The bias corrections ``1 - b**count``
    are computed in the moments' precision, as optax computes them, once
    into a table on the device (``_bias_corrections``), and each moment is
    divided by its table entry at the device count.  With ``group_lrs``
    each top-level key of the params takes its own rate, which for an
    elementwise method is exactly optax's ``multi_transform`` of one Adam
    per group."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    capturable = True

    def __init__(self, learning_rate: float = 1e-3, group_lrs=None):
        self.learning_rate = learning_rate
        self.group_lrs = None if group_lrs is None else dict(group_lrs)

    def init(self, x: torch.Tensor, like=None) -> AdamState:
        lr = self.learning_rate
        if self.group_lrs is not None:
            lr = torch.empty_like(x)
            for k, (a, b) in _key_ranges(like).items():
                if k not in self.group_lrs:
                    raise KeyError(f"no learning rate for group {k!r}")
                lr[a:b] = self.group_lrs[k]
        return AdamState(count=0, device_count=_device_count(x),
                         mu=torch.zeros_like(x), nu=torch.zeros_like(x),
                         lr=lr)

    advance = staticmethod(_advance)

    def update(self, g: torch.Tensor, state: AdamState, x: torch.Tensor
               ) -> Tuple[torch.Tensor, AdamState]:
        b1, b2 = self.b1, self.b2
        mu = state.mu.copy_((1 - b1) * g + b1 * state.mu)
        nu = state.nu.copy_((1 - b2) * (g * g) + b2 * state.nu)
        k = state.device_count.add_(1)
        c1 = _bias_corrections(b1, g.dtype, g.device)
        c2 = _bias_corrections(b2, g.dtype, g.device)
        # take, not c1[k]: a 0-dim index would be read on the host
        mu_hat = mu / torch.take(c1, k.clamp(max=c1.shape[0] - 1))
        nu_hat = nu / torch.take(c2, k.clamp(max=c2.shape[0] - 1))
        lr = state.lr
        step = (mu_hat / (torch.sqrt(nu_hat) + self.eps)) * (-lr)
        return step, state._replace(count=state.count + 1)


class FreezeGroups:
    """``inner`` on the entries of the params keys not in ``frozen`` (the
    inner optimizer sees only those, as optax's ``multi_transform`` gives
    them), and a zero step on the frozen keys' entries."""

    def __init__(self, inner, frozen_keys):
        self.inner = inner
        self.frozen = set(frozen_keys)

    @property
    def capturable(self) -> bool:
        return getattr(self.inner, "capturable", False)

    def init(self, x: torch.Tensor, like=None):
        ranges = [r for k, r in _key_ranges(like).items()
                  if k not in self.frozen]
        active = {k: like[k] for k in sorted(like) if k not in self.frozen}
        return ranges, self.inner.init(self._take(x, ranges), like=active)

    def advance(self, state, n: int):
        ranges, inner_state = state
        return ranges, self.inner.advance(inner_state, n)

    @staticmethod
    def _take(v, ranges):
        return torch.cat([v[a:b] for a, b in ranges]) if ranges \
            else v[:0]

    def update(self, g: torch.Tensor, state, x: torch.Tensor):
        ranges, inner_state = state
        step_a, inner_state = self.inner.update(
            self._take(g, ranges), inner_state, self._take(x, ranges))
        step = torch.zeros_like(x)
        i = 0
        for a, b in ranges:
            step[a:b] = step_a[i:i + b - a]
            i += b - a
        return step, (ranges, inner_state)


def adam(learning_rate: float = 1e-3) -> Adam:
    """optax's ``adam(learning_rate)``."""
    return Adam(learning_rate)


def adam_per_group(group_lrs) -> Adam:
    """Adam with a separate learning rate per top-level parameter key:
    ``adam_per_group({"u": 1e-4, "coords": 1e-5})`` is the reference's
    two-group configuration (``examples/example4.py:54-57``)."""
    return Adam(group_lrs=group_lrs)


def freeze_groups(inner, frozen_keys) -> FreezeGroups:
    """Wrap an optimizer so that the given top-level keys receive zero
    updates (the reference's alternating freeze scheme,
    ``examples/example4.py:83-109``, as a first-class optimizer)."""
    return FreezeGroups(inner, frozen_keys)
