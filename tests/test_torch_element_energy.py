"""The port's fused element energy (``hidenn_fem_tpu_torch/ops/
element_energy.py``) against the JAX package's Pallas kernel
(``element_energy_pallas`` in interpret mode, and its ``jax.grad``).

Tolerances.  In f32: rtol 1e-5 on the value (sums taken in another
order); rtol 5e-4 on the gradients, as ``tests/test_pallas_energy.py``
states for the same kernel, with atol 1e-8 x max|grad|: the coordinate
entries are sums of terms ~1e6 times larger that cancel, and there JAX's
own f32 gradient is off from an f64 reference by up to 2e-3 absolute (on
entries ~1, of a largest ~1.7e6).  In f64 (JAX under ``jax.enable_x64``):
rtol 1e-12 on the value, rtol 1e-10 with atol 1e-12 x max|grad| on the
gradients, which shows that the formulas are the same and not only close.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hidenn_fem_tpu.ops.pallas_energy import element_energy_pallas
from hidenn_fem_tpu_torch.ops import element_energy as ee
from hidenn_fem_tpu_torch.ops.assembly import gather_with_incidence
from hidenn_fem_tpu_torch.mesh.types import build_incidence_table

from torch_port_common import assert_close

E, NU, W_SUM = 10e9, 0.3, 0.5
T_X = 100e3


def _random_columns(ne, seed):
    """[ne, 3, 4] corners: mesh-like triangles (a right triangle of side
    0.05 with 10% corner noise, anywhere in the unit square), half of
    them clockwise, and 1e-4-scale displacements."""
    rng = np.random.default_rng(seed)
    h = 0.05
    base = np.asarray([[0.0, 0.0], [h, 0.0], [0.0, h]])
    xy = (base[None] + 0.1 * h * rng.standard_normal((ne, 3, 2))
          + rng.uniform(0.0, 1.0, (ne, 1, 2)))
    flip = rng.random(ne) < 0.5
    xy[flip] = xy[flip][:, [1, 0, 2]]
    u = 1e-4 * rng.standard_normal((ne, 3, 2))
    return np.concatenate([xy, u], axis=-1).astype(np.float32)


def _special_columns():
    """Negative det, det just below and above the 1e-12 guard, an
    all-zero column, an all-equal degenerate column and a collinear column
    (det == 0 exactly, strains nonzero)."""
    u = np.float32(1e-4)
    cols = [
        # clockwise triangle: det < 0
        [[0.0, 0.0, u, 0.0], [0.0, 1.0, 0.0, u], [1.0, 0.0, -u, u]],
        # det = 5e-13 < 1e-12 (guarded)
        [[1e-6, 0.0, u, 0.0], [0.0, 5e-7, 0.0, -u], [0.0, 0.0, 0.0, 0.0]],
        # det = 2e-12 > 1e-12
        [[2e-6, 0.0, u, 0.0], [0.0, 1e-6, 0.0, -u], [0.0, 0.0, 0.0, 0.0]],
        # zero column
        [[0.0] * 4] * 3,
        # all three corners equal
        [[0.25, 0.5, u, -u]] * 3,
        # collinear: corners on the line y = x
        [[0.5, 0.5, u, 0.0], [0.25, 0.25, 0.0, u], [0.0, 0.0, 0.0, 0.0]],
    ]
    return np.asarray(cols, dtype=np.float32)


def _jax_value_and_grad(g, edge_start=None, tw=0.0):
    """Value and gradient of the Pallas kernel (interpret mode), in the
    dtype of ``g`` (f64 under ``jax.enable_x64``)."""
    with jax.enable_x64(g.dtype == np.float64):
        gT = jnp.asarray(g.reshape(g.shape[0], 12).T, dtype=g.dtype)

        def f(gT):
            return element_energy_pallas(gT, E, NU, W_SUM, True,
                                         edge_start, tw)

        v, dgT = jax.jit(jax.value_and_grad(f))(gT)
        return float(v), np.asarray(dgT).T.reshape(g.shape)


def _torch_value_and_grad(g, edge_start=None, tw=0.0):
    t = torch.tensor(g, requires_grad=True)
    v = ee.element_energy_plain(t, E, NU, W_SUM, edge_start, tw)
    (grad,) = torch.autograd.grad(v, t)
    return float(v.detach()), grad.numpy()


def _hand_cotangent(g, ct=1.0, edge_start=None, tw=0.0):
    t = torch.tensor(g)
    return ee.element_cotangent_plain(t, torch.tensor(ct, dtype=t.dtype), E,
                                      NU, W_SUM, edge_start, tw).numpy()


def _assert_grad_close(actual, expected, what=""):
    """The f32 gradient tolerance of the module docstring."""
    assert_close(actual, expected, rtol=5e-4,
                 atol=1e-8 * np.abs(expected).max(), what=what)


def _edge_columns(ne_edges, seed):
    """Neumann edge pseudo-elements (n0, n1, n1) on the x = 2 face."""
    rng = np.random.default_rng(seed)
    y0 = rng.uniform(0.0, 1.0, ne_edges)
    y1 = y0 + rng.uniform(0.01, 0.05, ne_edges)
    v0 = np.stack([np.full(ne_edges, 2.0), y0,
                   1e-4 * rng.standard_normal(ne_edges),
                   1e-4 * rng.standard_normal(ne_edges)], axis=1)
    v1 = np.stack([np.full(ne_edges, 2.0), y1,
                   1e-4 * rng.standard_normal(ne_edges),
                   1e-4 * rng.standard_normal(ne_edges)], axis=1)
    return np.stack([v0, v1, v1], axis=1).astype(np.float32)


CASES = {
    "random": lambda: _random_columns(500, 0),
    "special": _special_columns,
    "ragged_3001": lambda: _random_columns(3001, 1),
    "mixed": lambda: np.concatenate([_random_columns(257, 2),
                                     _special_columns()]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_value_matches_pallas(case):
    g = CASES[case]()
    v_jax, _ = _jax_value_and_grad(g)
    v_pt, _ = _torch_value_and_grad(g)
    assert np.isclose(v_pt, v_jax, rtol=1e-5, atol=0.0), (v_pt, v_jax)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_matches_pallas(case):
    """Both the autograd gradient of the plain energy and the hand-derived
    cotangent of the backward kernel match JAX's in-kernel AD."""
    g = CASES[case]()
    _, d_jax = _jax_value_and_grad(g)
    _, d_auto = _torch_value_and_grad(g)
    d_hand = _hand_cotangent(g)
    _assert_grad_close(d_auto, d_jax, what="autograd")
    _assert_grad_close(d_hand, d_jax, what="hand")


@pytest.mark.parametrize("with_edges", [False, True])
def test_value_and_grad_match_pallas_f64(with_edges):
    """In f64 the plain energy, its autograd gradient and the hand-derived
    cotangent equal the Pallas kernel's value and in-kernel AD to
    rounding."""
    g = np.concatenate([_random_columns(2500, 8), _special_columns(),
                        _edge_columns(30, 9)]).astype(np.float64)
    edge_start, tw = (g.shape[0] - 30, -T_X) if with_edges else (None, 0.0)
    v_jax, d_jax = _jax_value_and_grad(g, edge_start, tw)
    v_pt, d_auto = _torch_value_and_grad(g, edge_start, tw)
    d_hand = _hand_cotangent(g, 1.0, edge_start, tw)
    assert np.isclose(v_pt, v_jax, rtol=1e-12, atol=0.0), (v_pt, v_jax)
    atol = 1e-12 * np.abs(d_jax).max()
    assert_close(d_auto, d_jax, rtol=1e-10, atol=atol, what="autograd")
    assert_close(d_hand, d_jax, rtol=1e-10, atol=atol, what="hand")


def test_special_columns_exact_zeros_and_abs_convention():
    """Zero and all-equal columns give exactly 0 energy and 0 cotangent;
    the collinear column has 0 energy but a nonzero det-gradient, the +1
    convention of jax.grad(jnp.abs) at 0 (torch.abs would give 0)."""
    g = _special_columns()
    d_hand = _hand_cotangent(g)
    _, d_jax = _jax_value_and_grad(g)
    for i in (3, 4):
        assert ee.element_energy_plain(torch.tensor(g[i:i + 1]), E, NU,
                                       W_SUM).item() == 0.0
        assert np.all(d_hand[i] == 0.0)
        assert np.all(d_jax[i] == 0.0)
    collinear = g[5:6]
    assert ee.element_energy_plain(torch.tensor(collinear), E, NU,
                                   W_SUM).item() == 0.0
    assert np.abs(d_jax[5]).max() > 0.0
    _assert_grad_close(d_hand[5], d_jax[5])


@pytest.mark.parametrize("ct", [1.0, -2.5])
def test_edge_variant_matches_pallas(ct):
    """Columns >= edge_start add tw * ds * (u0x + u1x) / 2 (tw = -t_x);
    the edge pseudo-elements' elastic term is exactly 0."""
    g = np.concatenate([_random_columns(700, 3), _edge_columns(40, 4),
                        np.zeros((1, 3, 4), np.float32)])
    edge_start, tw = 700, -T_X
    v_jax, d_jax = _jax_value_and_grad(g, edge_start, tw)
    v_pt, d_auto = _torch_value_and_grad(g, edge_start, tw)
    assert np.isclose(v_pt, v_jax, rtol=1e-5), (v_pt, v_jax)
    _assert_grad_close(d_auto, d_jax, what="autograd")
    d_hand = _hand_cotangent(g, ct, edge_start, tw)
    _assert_grad_close(d_hand, ct * d_jax, what="hand")
    # the zero column past edge_start: ds is clamped to 1e-15, so its
    # gradient stays finite (and is at most |ct tw| 1e-15 / 2 in u_x)
    assert np.all(np.isfinite(d_hand))
    assert np.abs(d_hand[-1]).max() <= abs(ct * tw) * 1e-15


def _small_mesh_nodes(dtype, seed=5):
    rng = np.random.default_rng(seed)
    nx, ny = 5, 4
    xs, ys = np.meshgrid(np.linspace(0, 1, nx), np.linspace(0, 1, ny),
                         indexing="ij")
    xy = np.stack([xs.ravel(), ys.ravel()], 1)
    xy = xy + 0.02 * rng.standard_normal(xy.shape)
    u = 0.1 * rng.standard_normal(xy.shape)
    i, j = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1), indexing="ij")
    n00 = (i * ny + j).ravel()
    n10 = n00 + ny
    conn = np.concatenate([np.stack([n00, n10, n10 + 1], 1),
                           np.stack([n00, n10 + 1, n00 + 1], 1)])
    node = torch.tensor(np.concatenate([xy, u], 1), dtype=dtype)
    return node, conn.astype(np.int32)


@pytest.mark.parametrize("with_edges", [False, True])
def test_autograd_function_gradcheck_f64(with_edges):
    """gradcheck of the autograd Function on the CPU (plain) path in f64:
    the hand-derived cotangent and the incidence assembly against finite
    differences (O(1) material constants keep the differences well
    conditioned)."""
    node, conn = _small_mesh_nodes(torch.float64)
    edge_start = tw = None
    if with_edges:
        edges = np.asarray([[16, 17], [17, 18], [18, 19]], np.int32)
        edge_start, tw = conn.shape[0], -0.7
        conn = np.concatenate([conn, np.concatenate(
            [edges, edges[:, 1:]], 1)]).astype(np.int32)
    inc = torch.as_tensor(build_incidence_table(conn, node.shape[0]))
    conn_t = torch.as_tensor(conn)
    node.requires_grad_(True)

    def f(node):
        return ee.element_energy(node, conn_t, inc, 1.0, 0.3, 0.5,
                                 edge_start, tw or 0.0)

    assert torch.autograd.gradcheck(f, (node,), eps=1e-6, atol=1e-7,
                                    rtol=1e-5)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    """On CPU tensors the wrapper runs the plain versions (same value and
    node gradient as gather + plain autograd) and launches nothing; the
    kernel entry points refuse CPU tensors."""
    node, conn = _small_mesh_nodes(torch.float32)
    inc = torch.as_tensor(build_incidence_table(conn, node.shape[0]))
    conn_t = torch.as_tensor(conn)
    ee.reset_launch_counts()
    a = node.clone().requires_grad_(True)
    v1 = ee.element_energy(a, conn_t, inc, E, NU, W_SUM)
    (g1,) = torch.autograd.grad(v1, a)
    b = node.clone().requires_grad_(True)
    v2 = ee.element_energy_plain(gather_with_incidence(b, conn_t, inc), E,
                                 NU, W_SUM)
    (g2,) = torch.autograd.grad(v2, b)
    assert np.isclose(float(v1), float(v2), rtol=1e-6)
    _assert_grad_close(g1, g2)
    assert set(ee.launch_counts.values()) == {0}
    with pytest.raises(ValueError):
        ee.element_energy_fwd(node, conn_t, E, NU, W_SUM)
    with pytest.raises(ValueError):
        ee.element_energy_bwd(node, conn_t, torch.ones(()), E, NU, W_SUM)
    with pytest.raises(ValueError):
        ee.incidence_sum(torch.zeros((len(conn), 3, 4)), inc)


# ------------------------------------------------------------- assembly
def _incidence_case(nx, ny, seed):
    from hidenn_fem_tpu_torch.mesh.structured import rectangle_tri_zigzag
    _, cells = rectangle_tri_zigzag(nx, ny, 2.0, 1.0)
    n = nx * ny + 3                     # three nodes no element references
    rng = np.random.default_rng(seed)
    return cells.astype(np.int32), n, rng


def test_gather_with_incidence_backward_matches_jax():
    """The scatter-free backward equals JAX's, value and node gradient
    (rtol 1e-6: the same products summed in another order)."""
    from hidenn_fem_tpu.ops.assembly import gather_with_incidence as jg
    conn, n, rng = _incidence_case(13, 7, 10)
    inc = build_incidence_table(conn, n)
    node = rng.standard_normal((n, 4)).astype(np.float32)

    def loss_j(x):
        g = jg(x, jnp.asarray(conn), jnp.asarray(inc))
        return jnp.sum(jnp.sin(g) * g)

    gj = np.asarray(jax.jit(jax.grad(loss_j))(jnp.asarray(node)))
    x = torch.tensor(node, requires_grad=True)
    g = gather_with_incidence(x, torch.as_tensor(conn), torch.as_tensor(inc))
    (gt,) = torch.autograd.grad(torch.sum(torch.sin(g) * g), x)
    assert_close(gt, gj, rtol=1e-6, atol=1e-6)
    assert np.all(gt[-3:].numpy() == 0.0)


@pytest.mark.parametrize("nx,ny", [(13, 7), (121, 61)])
def test_incidence_gather_sums_match_jax(nx, ny):
    """Plain and weighted incidence gather-sums against JAX's, below and
    above its 16384-row split form (rtol 1e-6)."""
    from hidenn_fem_tpu.ops import assembly as ja
    from hidenn_fem_tpu_torch.ops import assembly as ta
    conn, n, rng = _incidence_case(nx, ny, 11)
    inc = build_incidence_table(conn, n)
    table = np.concatenate([rng.standard_normal((conn.size, 4)),
                            np.zeros((1, 4))]).astype(np.float32)
    w = rng.standard_normal(inc.shape).astype(np.float32)
    plain_j = np.asarray(ja.incidence_gather_sum(jnp.asarray(table),
                                                 jnp.asarray(inc)))
    weighted_j = np.asarray(ja.weighted_incidence_gather_sum(
        jnp.asarray(table), jnp.asarray(inc), jnp.asarray(w)))
    tt, it = torch.as_tensor(table), torch.as_tensor(inc)
    assert_close(ta.incidence_gather_sum(tt, it), plain_j, rtol=1e-6,
                 atol=1e-6)
    assert_close(ta.weighted_incidence_gather_sum(tt, it,
                                                  torch.as_tensor(w)),
                 weighted_j, rtol=1e-6, atol=1e-6)
