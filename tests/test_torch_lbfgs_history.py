"""The compact L-BFGS's two history passes (``ops/lbfgs_history.py``) on
the CPU, against the JAX package's products on the same numpy inputs.

The JAX package computes them inside ``scale_by_compact_lbfgs``'s
``_update`` (``hidenn_fem_tpu/solve/optimizers.py``) under
``default_matmul_precision("highest")``: the dots
``SY @ jnp.stack([y, s, g], 1)`` and the combination
``gamma * g + coef @ SY`` (times ``-learning_rate`` for a fixed step).
The port's wrappers run their plain versions on CPU tensors, so these are
the products a CPU solve takes.  The kernels themselves run only on the
card (``tests/test_torch_cuda.py``).

Tolerance, per entry: |port - JAX| <= RTOL x the same sum over absolute
values (|SY| @ |V|, and |gamma| |g| + |coef| @ |SY|), 1e-5 in float32
and 1e-13 in float64: the two sum in other orders, and S.g may cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidenn_fem_tpu_torch.ops import lbfgs_history as lh
from hidenn_fem_tpu_torch.solve import optimizers as topt

RTOL = {np.float32: 1e-5, np.float64: 1e-13}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


def _history(m, p, dtype, seed):
    """Numpy inputs of one update: SY [2m, P] after a wrapped history
    (count m + 2, the newest pair (s, y) in slot (m + 1) % m) in which,
    for m > 1, the next slot holds a rejected pair (its rows zero); y, s,
    g [P]; coef [2m] in the oldest-first order; gamma."""
    rng = np.random.default_rng(seed)
    SY = rng.standard_normal((2 * m, p))
    y, s, g = rng.standard_normal((3, p))
    slot = (m + 1) % m
    SY[slot], SY[m + slot] = s, y
    if m > 1:
        SY[[(slot + 1) % m, m + (slot + 1) % m]] = 0.0
    order = (m + 2 + np.arange(m)) % m
    coef = np.zeros(2 * m)
    coef[order] = rng.standard_normal(m)
    coef[m + order] = rng.standard_normal(m)
    gamma = np.asarray(rng.uniform(0.1, 2.0))
    return [a.astype(dtype) for a in (SY, y, s, g, coef, gamma)]


def _close(got, want, scale, rtol):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.all(err <= rtol * np.asarray(scale, np.float64)), \
        float((err / np.maximum(scale, 1e-300)).max())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("p", [1, 7, 4097])
def test_history_dots_match_jax(dtype, m, p):
    SY, y, s, g, _, _ = _history(m, p, dtype, seed=10 * m + p)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jnp.matmul(
            jnp.asarray(SY), jnp.stack([jnp.asarray(v) for v in (y, s, g)],
                                       1), precision="highest"))
    t = [torch.tensor(a) for a in (SY, y, s, g)]
    got = lh.history_dots(*t)
    assert got.dtype == TORCH[dtype] and got.shape == (2 * m, 3)
    assert torch.equal(got, lh.history_dots_plain(*t))
    scale = np.abs(SY).astype(np.float64) @ np.abs(np.stack([y, s, g], 1))
    _close(got.numpy(), want, scale, RTOL[dtype])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("p", [1, 7, 4097])
@pytest.mark.parametrize("learning_rate", [None, 0.5])
def test_history_combine_matches_jax(dtype, m, p, learning_rate):
    SY, _, _, g, coef, gamma = _history(m, p, dtype, seed=10 * m + p + 1)
    with jax.enable_x64(dtype == np.float64):
        with jax.default_matmul_precision("highest"):
            hg = jnp.asarray(gamma) * jnp.asarray(g) + \
                jnp.asarray(coef) @ jnp.asarray(SY)
        want = np.asarray(hg if learning_rate is None
                          else -learning_rate * hg)
    scale = 1.0 if learning_rate is None else -learning_rate
    t = [torch.tensor(a) for a in (SY, g, coef, gamma)]
    got = lh.history_combine(*t, scale)
    assert got.dtype == TORCH[dtype] and got.shape == (p,)
    assert torch.equal(got, lh.history_combine_plain(*t, scale))
    bound = abs(scale) * (abs(gamma) * np.abs(g).astype(np.float64)
                          + np.abs(coef) @ np.abs(SY).astype(np.float64))
    _close(got.numpy(), want, bound, RTOL[dtype])


def test_cpu_update_launches_no_kernel():
    """``CompactLBFGS.update`` on CPU tensors (f32 and f64, with and
    without a fixed step, past a wrapped history) takes the plain
    versions: both counters stay at 0."""
    lh.reset_launch_counts()
    rng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.float64):
        for lr in (None, 1.0):
            opt = topt.CompactLBFGS(memory_size=3, learning_rate=lr)
            x = torch.tensor(rng.standard_normal(11), dtype=dtype)
            state = opt.init(x)
            for _ in range(6):
                g = torch.tensor(rng.standard_normal(11), dtype=dtype)
                step, state = opt.update(g, state, x)
                x = x + 0.1 * step
            assert torch.isfinite(step).all()
    assert lh.launch_counts == {"lbfgs_history_dots": 0,
                                "lbfgs_history_combine": 0}


@pytest.mark.parametrize("which", ["dots", "combine"])
def test_wrappers_take_the_plain_version_only_on_the_cpu(which):
    """Tensors off the CPU (the meta device here, standing for the card)
    go to the kernel's checks, never to the plain version: a wrapper
    with SY or any operand off the CPU raises."""
    meta = torch.device("meta")
    SY, y, s, g, coef, gamma = (torch.tensor(a) for a in _history(
        2, 8, np.float32, seed=0))
    if which == "dots":
        calls = [lambda: lh.history_dots(SY.to(meta), y, s, g),
                 lambda: lh.history_dots(SY, y, s.to(meta), g)]
    else:
        calls = [lambda: lh.history_combine(SY.to(meta), g, coef, gamma),
                 lambda: lh.history_combine(SY, g, coef, gamma.to(meta))]
    for call in calls:
        with pytest.raises(ValueError, match="takes CUDA tensors"):
            call()
