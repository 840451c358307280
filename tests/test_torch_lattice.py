"""The port's lattice route (``mesh/lattice.py``, ``ops/lattice_energy.py``,
``ops/lattice_slab.py``, the lattice branch of ``PlaneStressEnergy``)
against the JAX package on the same numpy inputs.

* Detection: the same arrays and static flags for up/down/zigzag,
  hole-free and holed, renumbered and keep-dead meshes; the same
  rejections (mirroring ``tests/test_lattice_route.py``).
* ``lattice_total``: value and node gradient against JAX's, f32 (rtol
  1e-5 on the energy, rtol 5e-4 with atol 1e-5 x max|g| on the gradient:
  the coordinate gradients are sums of cancelling terms, see
  ``tests/test_torch_losses.py``) and f64 (rtol 1e-10 on both; the
  gradient's atol 1e-12 x max|g| for entries that cancel to ~0).
* The stencil kernels' plain versions (what K6/K7 compute) against JAX's
  ``lattice_slab`` run in interpret mode, as ``tests/test_lattice_slab.py``
  runs it, and the hand-derived node gradient against ``jax.grad``.
* ``PlaneStressEnergy.total`` takes the same route as JAX's on a default
  ``generate_mesh``, with a body force and a custom traction too.
* A short L-BFGS solve on the lattice route reaches JAX's plateau.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh.lattice import detect_lattice as jdetect
from hidenn_fem_tpu.ops import lattice_energy as jle
from hidenn_fem_tpu.ops import lattice_slab as jls
from hidenn_fem_tpu_torch.mesh.lattice import detect_lattice as tdetect
from hidenn_fem_tpu_torch.ops import lattice_energy as tle
from hidenn_fem_tpu_torch.ops import lattice_slab as tls

from torch_port_common import CPU, assert_close, assert_route_equal

E, NU, W_SUM, T_X = 10e9, 0.3, 0.5, 100e3
HOLES2 = ((0.6, 0.4, 0.15), (1.4, 0.6, 0.2))

MESHES = {
    "up": dict(holes=(), variant="up"),
    "down": dict(holes=(), variant="down"),
    "zigzag": dict(holes=(), variant="zigzag"),
    "zigzag_holes_renumbered": dict(holes=((1.0, 0.5, 0.25),)),
    "up_holes_renumbered": dict(holes=HOLES2, variant="up"),
    "zigzag_holes_keep_dead": dict(holes=HOLES2, keep_dead_nodes=True),
    "down_holes_keep_dead": dict(holes=HOLES2, variant="down",
                                 keep_dead_nodes=True),
    "dirichlet_top_neumann_bottom": dict(
        holes=(), boundaries={"up": 1, "down": 2, "right": 2, "left": 1}),
}


def _meshes(name, nx=33, ny=17):
    kw = MESHES[name]
    return ht.generate_mesh(nx=nx, ny=ny, **kw), \
        pt.generate_mesh(nx=nx, ny=ny, device=CPU, **kw)


def _node(mesh_j, seed, dtype=np.float32):
    """A packed [N, 4] node table: coords perturbed by 1e-3, u ~ 1e-4."""
    rng = np.random.default_rng(seed)
    n = mesh_j.n_nodes
    return np.concatenate(
        [np.asarray(mesh_j.coords, np.float64)
         + 1e-3 * rng.standard_normal((n, 2)),
         1e-4 * rng.standard_normal((n, 2))], axis=1).astype(dtype)


def _assert_grad(got, want, f64=False):
    rtol, atol = (1e-10, 1e-12) if f64 else (5e-4, 1e-5)
    assert_close(got, want, rtol=rtol, atol=atol * np.abs(want).max())


# ------------------------------------------------------------- detection
@pytest.mark.parametrize("name", sorted(MESHES))
def test_detect_lattice_matches_jax(name):
    jm, tm = _meshes(name)
    assert tm.lattice is not None
    assert_route_equal(tm.lattice, jm.lattice)
    # the same detection from the arrays of the JAX mesh
    assert_route_equal(pt.mesh_from_numpy(jm, device=CPU).lattice,
                       jm.lattice)


def _rejected_cases():
    mesh = ht.generate_mesh(nx=9, ny=5, holes=(), variant="up")
    coords = np.asarray(mesh.coords)
    conn = np.asarray(mesh.connectivity)
    edges = np.asarray(mesh.neumann_edges)
    rng = np.random.default_rng(0)
    mixed = conn.copy()
    mixed[0] = [0, 5, 1]          # down-T1 beside its up-T2 sibling
    dup = np.concatenate([conn, conn[:1]])
    return {
        "perturbed_coords": (coords + 0.01 * rng.standard_normal(
            coords.shape), conn, edges),
        "mixed_diagonals": (coords, mixed, np.zeros((0, 2))),
        "interior_neumann_edge": (coords, conn, np.array([[6, 7]])),
        "duplicate_triangle": (coords, dup, edges),
        "two_nodes_one_site": (np.concatenate([coords, coords[:1]]),
                               conn, edges),
        "too_few_triangles": (coords[:4], conn[:1], np.zeros((0, 2))),
    }


@pytest.mark.parametrize("case", sorted(_rejected_cases()))
def test_detect_lattice_rejects_like_jax(case):
    coords, conn, edges = _rejected_cases()[case]
    assert jdetect(coords, conn, edges) is None
    assert tdetect(coords, conn, edges, device=CPU) is None


def test_mesh_to_moves_the_route():
    tm = pt.generate_mesh(nx=17, ny=9, holes=((1.0, 0.5, 0.25),),
                          device=CPU)
    moved = tm.to("meta")
    route = moved.lattice
    for t in (route.sel, route.t1, route.t2, route.inv_map, route.fwd_map,
              *route.edge_masks.values()):
        assert t.device.type == "meta"
    assert (route.nx, route.ny, route.identity) == \
        (tm.lattice.nx, tm.lattice.ny, tm.lattice.identity)
    assert pt.generate_mesh(nx=17, ny=9,
                            device=CPU).to("cpu").lattice is not None


# ------------------------------------------------------ lattice_total
@pytest.mark.parametrize("name", ["up", "zigzag_holes_renumbered",
                                  "zigzag_holes_keep_dead"])
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_lattice_total_matches_jax(name, f64):
    """Value and node gradient; the renumbered mesh runs the permutation
    fill (``_perm_fill``), the others the identity reshape."""
    jm, tm = _meshes(name)
    node = _node(jm, seed=1, dtype=np.float64 if f64 else np.float32)
    with jax.enable_x64(f64):
        vj, gj = jax.value_and_grad(
            lambda n: jle.lattice_total(n, jm.lattice, E, NU, W_SUM, T_X,
                                        3e4))(jnp.asarray(node))
        vj, gj = float(vj), np.asarray(gj)
    x = torch.tensor(node, requires_grad=True)
    vt = tle.lattice_total(x, tm.lattice, E, NU, W_SUM, T_X, 3e4)
    (gt,) = torch.autograd.grad(vt, x)
    assert vt.dtype == x.dtype
    v = float(vt.detach())
    assert np.isclose(v, vj, rtol=1e-10 if f64 else 1e-5), (v, vj)
    _assert_grad(gt.numpy(), gj, f64)


def test_perm_fill_backward_is_the_gather():
    """``_perm_fill``'s backward (a gather through fwd_map) equals the
    autograd of the dense fill."""
    rng = np.random.default_rng(3)
    n, nxny = 7, 12
    posns = rng.permutation(nxny)[:n]
    inv_map = np.full(nxny, n, np.int32)
    inv_map[posns] = np.arange(n)
    node = torch.tensor(rng.standard_normal((n, 4)), requires_grad=True)
    ct = torch.tensor(rng.standard_normal((nxny, 4)))
    out = tle._perm_fill(node, torch.as_tensor(inv_map),
                         torch.as_tensor(posns.astype(np.int32)))
    (g,) = torch.autograd.grad(torch.sum(out * ct), node)
    pad = torch.cat([node, torch.zeros((1, 4), dtype=node.dtype)])
    (g_ref,) = torch.autograd.grad(
        torch.sum(pad[torch.as_tensor(inv_map).long()] * ct), node)
    np.testing.assert_array_equal(g.numpy(), g_ref.numpy())


# ---------------------------------------------- stencil kernels' plain
@pytest.mark.parametrize("name", ["up", "down", "zigzag",
                                  "zigzag_holes_keep_dead",
                                  "down_holes_keep_dead"])
def test_slab_plain_matches_jax_interpret(name):
    """``lattice_total_slab`` on CPU tensors (the plain K6 for the value
    and gradient, the plain K7 under no_grad) against JAX's
    ``lattice_total_slab(interpret=True)``; the hand-derived node gradient
    of ``lattice_stencil_vg_plain`` against ``jax.grad`` of JAX's lattice
    route domain energy."""
    jm, tm = _meshes(name)
    route = tm.lattice
    assert tls.slab_supported(route, torch.float32)
    node = _node(jm, seed=2)
    vj, gj = jax.value_and_grad(
        lambda n: jls.lattice_total_slab(n, jm.lattice, E, NU, W_SUM, T_X,
                                         interpret=True))(jnp.asarray(node))
    x = torch.tensor(node, requires_grad=True)
    vt = tls.lattice_total_slab(x, route, E, NU, W_SUM, T_X)
    (gt,) = torch.autograd.grad(vt, x)
    assert np.isclose(float(vt.detach()), float(vj), rtol=1e-5)
    _assert_grad(gt.numpy(), np.asarray(gj))
    with torch.no_grad():
        v7 = tls.lattice_total_slab(torch.tensor(node), route, E, NU, W_SUM,
                                    T_X)
    assert float(v7) == float(vt)      # plain K7 == plain K6's energy

    vd, gd = jax.value_and_grad(
        lambda n: jle.lattice_domain_energy(n, jm.lattice, E, NU, W_SUM))(
        jnp.asarray(node))
    e6, g6 = tls.lattice_stencil_vg_plain(
        torch.tensor(node), route.nx, route.ny, E, NU, W_SUM,
        **tls.route_stencil(route))
    assert np.isclose(float(e6), float(vd), rtol=1e-5)
    _assert_grad(g6.numpy(), np.asarray(gd))
    assert set(tls.launch_counts.values()) == {0}


@pytest.mark.parametrize("diag", ["sel_mask", "parity"])
def test_stencil_plain_gradient_is_autograd_of_plain_energy_f64(diag):
    """The hand-derived gradient (K6's formula) equals autograd of the
    plain energy (K7's function) in f64, for a per-quad sel mask and the
    zigzag parity, with presence weights."""
    nx, ny = 11, 7
    rng = np.random.default_rng(5)
    xs, ys = np.meshgrid(np.linspace(0, 2, nx), np.linspace(0, 1, ny),
                         indexing="ij")
    node = np.stack([xs, ys], -1).reshape(-1, 2)
    node = np.concatenate([node + 1e-2 * rng.standard_normal(node.shape),
                           1e-3 * rng.standard_normal(node.shape)], 1)
    t1 = torch.tensor((rng.random((nx - 1, ny - 1)) > 0.2).astype(float))
    t2 = torch.tensor((rng.random((nx - 1, ny - 1)) > 0.2).astype(float))
    kw = (dict(diag=tls.SEL_MASK,
               sel=torch.tensor((rng.random((nx - 1, ny - 1)) > 0.5)
                                .astype(float)))
          if diag == "sel_mask" else dict(diag=tls.PARITY, phase=1))
    x = torch.tensor(node, requires_grad=True)
    v = tls.lattice_stencil_fwd_plain(x, nx, ny, E, NU, W_SUM, t1=t1, t2=t2,
                                      **kw)
    (g_auto,) = torch.autograd.grad(v, x)
    e, g = tls.lattice_stencil_vg_plain(x, nx, ny, E, NU, W_SUM, t1=t1,
                                        t2=t2, **kw)
    assert float(e) == float(v)
    _assert_grad(g.numpy(), g_auto.numpy(), f64=True)


def test_kernel_wrappers_refuse_cpu_tensors():
    tm = pt.proxy_plate_mesh(nx=9, ny=5, device=CPU)
    node = torch.zeros((45, 4))
    with pytest.raises(ValueError):
        tls.lattice_stencil_fwd(node, 9, 5, E, NU, W_SUM)
    with pytest.raises(ValueError):
        tls.lattice_stencil_vg(node, 9, 5, E, NU, W_SUM)
    kernel = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="kernel")
    p = pt.TriangleP1().init(torch.Generator().manual_seed(0), tm,
                             device=CPU)
    with pytest.raises(ValueError):
        kernel.total(p, tm)


# ----------------------------------------------------- losses routing
def _bf_j(x):
    return jnp.stack([jnp.sin(x[:, 0]) * 1e4, x[:, 1] * 2e4], axis=1)


def _bf_t(x):
    return torch.stack([torch.sin(x[:, 0]) * 1e4, x[:, 1] * 2e4], dim=1)


def _tr_j(x):
    return jnp.stack([1e5 * (1 + x[:, 1]), 3e4 * x[:, 1]], axis=1)


def _tr_t(x):
    return torch.stack([1e5 * (1 + x[:, 1]), 3e4 * x[:, 1]], dim=1)


CONFIGS = {
    "default": ({}, {}),
    "body_force": (dict(body_force=_bf_j), dict(body_force=_bf_t)),
    "traction": (dict(traction=_tr_j), dict(traction=_tr_t)),
}


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("name", ["zigzag_holes_renumbered",
                                  "zigzag_holes_keep_dead"])
def test_total_takes_the_jax_route(config, name):
    """On a default ``generate_mesh`` both packages take the lattice route
    first; value and both parameter gradients agree."""
    jm, tm = _meshes(name)
    jkw, tkw = CONFIGS[config]
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(), **jkw)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(), **tkw)
    node = _node(jm, seed=4)
    params_np = {"coords": node[:, :2], "u": node[:, 2:]}
    pj = {k: jnp.asarray(v) for k, v in params_np.items()}
    ptt = pt.params_from_numpy(params_np, device=CPU)
    assert je._lattice_total(pj, jm) is not None
    assert te._lattice_total(ptt, tm) is not None
    vj, gj = jax.value_and_grad(lambda p: je.total(p, jm))(pj)
    for v in ptt.values():
        v.requires_grad_(True)
    vt = te.total(ptt, tm)
    gt = torch.autograd.grad(vt, [ptt["coords"], ptt["u"]])
    assert np.isclose(float(vt.detach()), float(vj), rtol=1e-5)
    for k, g in zip(("coords", "u"), gt):
        _assert_grad(g.numpy(), np.asarray(gj[k]))


def test_route_opt_outs_match_jax():
    """compat="reference" leaves the lattice route in both packages; a
    mesh without a route never takes it."""
    jm, tm = _meshes("up", nx=17, ny=9)
    pj = ht.TriangleP1().init(jax.random.PRNGKey(0), jm)
    ptt = pt.TriangleP1().init(torch.Generator().manual_seed(0), tm,
                               device=CPU)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(compat="reference"),
                              compat="reference")
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(compat="reference"),
                              compat="reference")
    assert je._lattice_total(pj, jm) is None
    assert te._lattice_total(ptt, tm) is None
    te = pt.PlaneStressEnergy(model=pt.TriangleP1())
    assert te._lattice_total(ptt, dataclasses.replace(tm,
                                                      lattice=None)) is None
    node = pt.TriangleP1().packed_nodes(ptt, tm)
    assert np.isclose(float(te.total_from_nodes(node, tm)),
                      float(te.total(ptt, tm)), rtol=1e-6)


def test_lbfgs_on_lattice_route_reaches_jax_plateau():
    """120 fixed-step L-BFGS steps on the 33x17 proxy plate, lattice route
    in both packages, from one numpy init: the same plateau (rtol 1e-4,
    the bound ``tests/test_lattice_route.py`` holds the JAX route to)."""
    jm = ht.proxy_plate_mesh(nx=33, ny=17)
    tm = pt.proxy_plate_mesh(nx=33, ny=17, device=CPU)
    assert jm.lattice is not None and tm.lattice is not None
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((jm.n_nodes, 2))
    coords = np.asarray(jm.coords)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1())
    te = pt.PlaneStressEnergy(model=pt.TriangleP1())
    _, lj = ht.run_lbfgs(je.total, {"coords": jnp.asarray(coords),
                                    "u": jnp.asarray(u0, jnp.float32)},
                         num_steps=120, loss_args=(jm,))
    _, lt = pt.run_lbfgs(te.total, pt.params_from_numpy(
        {"coords": coords, "u": u0}, device=CPU), num_steps=120,
        loss_args=(tm,))
    assert np.isfinite(float(lt[-1])) and float(lt[-1]) < float(lt[0])
    assert np.isclose(float(lt[-1]), float(np.asarray(lj)[-1]), rtol=1e-4)
