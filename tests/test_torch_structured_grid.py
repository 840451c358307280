"""The port's structured path (``models/structured_grid.py`` and its
stencil kernels' plain versions) against the JAX package on the same
numpy inputs.

Tolerances: f32 rtol 1e-5 on energies (sums in another order), rtol 5e-4
with atol 1e-5 x max|g| on gradients (cancelling coordinate terms, see
``tests/test_torch_losses.py``); f64 (JAX under ``jax.enable_x64``) rtol
1e-10 on energies and gradients (atol 1e-12 x max|g|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.models import structured_grid as jsg
from hidenn_fem_tpu.ops.lattice_slab import \
    structured_domain_slab as jslab3
from hidenn_fem_tpu_torch.models import structured_grid as tsg
from hidenn_fem_tpu_torch.ops import lattice_slab as tls

from torch_port_common import CPU, assert_close, assert_route_equal

HOLE = ((1.0, 0.5, 0.3),)


def _grids(nx=17, ny=9, holes=HOLE, split="up", **kw):
    g_j = jsg.generate_structured_grid(nx=nx, ny=ny, holes=holes,
                                       split=split, **kw)
    g_t = tsg.generate_structured_grid(nx=nx, ny=ny, holes=holes,
                                       split=split, device=CPU, **kw)
    return g_j, g_t


def _assert_grid_equal(g_t, g_j):
    for name in ("coords", "geom_boundary_mask", "dirichlet_mask",
                 "quad_mask"):
        np.testing.assert_array_equal(getattr(g_t, name).numpy(),
                                      np.asarray(getattr(g_j, name)),
                                      err_msg=name)
    assert sorted(g_t.neumann_edge_masks) == sorted(g_j.neumann_edge_masks)
    for f, m in g_j.neumann_edge_masks.items():
        np.testing.assert_array_equal(g_t.neumann_edge_masks[f].numpy(),
                                      np.asarray(m), err_msg=f)
    assert (g_t.u_dirichlet is None) == (g_j.u_dirichlet is None)
    if g_j.u_dirichlet is not None:
        np.testing.assert_array_equal(g_t.u_dirichlet.numpy(),
                                      np.asarray(g_j.u_dirichlet))
    assert (g_t.split, g_t.zigzag_phase, g_t.nx, g_t.ny, g_t.n_elements) \
        == (g_j.split, g_j.zigzag_phase, g_j.nx, g_j.ny, g_j.n_elements)


def _params(g_j, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    shape = np.asarray(g_j.coords).shape
    return {"coords": (np.asarray(g_j.coords, np.float64)
                       + 1e-3 * rng.standard_normal(shape)).astype(dtype),
            "u": (1e-4 * rng.standard_normal(shape)).astype(dtype)}


def _value_and_grads(m_j, m_t, g_j, g_t, params_np, f64=False):
    with jax.enable_x64(f64):
        pj = {k: jnp.asarray(v) for k, v in params_np.items()}
        vj, gj = jax.value_and_grad(lambda p: m_j.total(p, g_j))(pj)
        vj, gj = float(vj), {k: np.asarray(v) for k, v in gj.items()}
    ptt = pt.params_from_numpy(
        params_np, device=CPU,
        dtype=torch.float64 if f64 else torch.float32)
    for v in ptt.values():
        v.requires_grad_(True)
    vt = m_t.total(ptt, g_t)
    gt = torch.autograd.grad(vt, [ptt["coords"], ptt["u"]])
    return vj, gj, float(vt.detach()), dict(zip(("coords", "u"),
                                                (g.numpy() for g in gt)))


def _assert_vg(vj, gj, vt, gt, f64=False):
    assert np.isclose(vt, vj, rtol=1e-10 if f64 else 1e-5), (vt, vj)
    rtol, scale = (1e-10, 1e-12) if f64 else (5e-4, 1e-5)
    for k in ("coords", "u"):
        assert_close(gt[k], gj[k], rtol=rtol,
                     atol=scale * np.abs(gj[k]).max(), what=k)


GRID_CASES = {
    "up_hole": dict(split="up"),
    "down_hole": dict(split="down"),
    "zigzag_hole": dict(split="zigzag"),
    "zigzag_no_holes": dict(split="zigzag", holes=()),
    "all_faces": dict(split="down", boundaries={"up": 2, "down": 2,
                                                "right": 2, "left": 1}),
    "u_dirichlet": dict(split="up", u_dirichlet=1e-4,
                        boundaries={"up": 1, "down": 0, "right": 2,
                                    "left": 1}),
}


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_generate_structured_grid_equal(case):
    g_j, g_t = _grids(**GRID_CASES[case])
    _assert_grid_equal(g_t, g_j)
    _assert_grid_equal(pt.grid_from_numpy(g_j, device=CPU), g_j)
    with pytest.raises(ValueError):
        tsg.generate_structured_grid(nx=5, ny=3, split="diagonal")


@pytest.mark.parametrize("case", sorted(GRID_CASES))
@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_total_and_both_gradients_match_jax(case, f64):
    """The plain stencil (the CPU path) for every split, with holes, all
    traction faces, per-face traction vectors and prescribed values."""
    g_j, g_t = _grids(**GRID_CASES[case])
    tractions = {"up": (2e4, -3e4)} if case == "all_faces" else None
    with jax.enable_x64(f64):
        m_j = jsg.StructuredGridP1(
            tractions=tractions, dtype=jnp.float64 if f64 else jnp.float32)
    m_t = tsg.StructuredGridP1(
        tractions=tractions, dtype=torch.float64 if f64 else torch.float32)
    params_np = _params(g_j, seed=1,
                        dtype=np.float64 if f64 else np.float32)
    _assert_vg(*_value_and_grads(m_j, m_t, g_j, g_t, params_np, f64), f64)


@pytest.mark.parametrize("split,phase", [("up", 0), ("down", 0),
                                         ("zigzag", 0), ("zigzag", 1)])
def test_structured_domain_slab_plain_matches_jax_interpret(split, phase):
    """``structured_domain_slab`` on CPU tensors (the plain K6/K7) against
    JAX's in interpret mode, holes and the zigzag parity included."""
    g_j, g_t = _grids(nx=33, ny=17, split=split)
    g_j = dataclasses.replace(g_j, zigzag_phase=phase)
    g_t = dataclasses.replace(g_t, zigzag_phase=phase)
    params_np = _params(g_j, seed=2)
    m_j, m_t = jsg.StructuredGridP1(), tsg.StructuredGridP1()
    node_j = m_j._node({k: jnp.asarray(v) for k, v in params_np.items()},
                       g_j)
    vj, gj = jax.value_and_grad(
        lambda n: jslab3(n, g_j.quad_mask, split, phase, m_j.E, m_j.nu,
                         interpret=True))(node_j)
    node_t = torch.tensor(np.asarray(node_j), requires_grad=True)
    vt = tls.structured_domain_slab(node_t, g_t.quad_mask, split, phase,
                                    m_t.E, m_t.nu)
    (gt,) = torch.autograd.grad(vt, node_t)
    assert np.isclose(float(vt.detach()), float(vj), rtol=1e-5)
    assert_close(gt.numpy(), np.asarray(gj), rtol=5e-4,
                 atol=1e-5 * np.abs(np.asarray(gj)).max())
    # ... and equal to the model's plain stencil
    ref = m_t._domain_from_node(node_t.detach(), g_t)
    assert np.isclose(float(vt.detach()), float(ref), rtol=1e-6)
    assert set(tls.launch_counts.values()) == {0}


def test_pad_lattice_and_zigzag_phase_match_jax():
    """Prepending dead rows shifts the zigzag phase; the padded grid, the
    padded params and the energy equal JAX's, and the energy equals the
    unpadded one."""
    g_j, g_t = _grids(nx=15, ny=9, split="zigzag")
    params_np = _params(g_j, seed=3)
    g2_j, p2_j = jsg.pad_lattice(g_j, {k: jnp.asarray(v) for k, v in
                                       params_np.items()}, 4)
    g2_t, p2_t = tsg.pad_lattice(g_t, pt.params_from_numpy(params_np,
                                                           device=CPU), 4)
    assert g2_t.nx == 16 and g2_t.zigzag_phase == 1
    assert tsg.pad_lattice_side(g_t) == jsg.pad_lattice_side(g_j)
    _assert_grid_equal(g2_t, g2_j)
    for k in ("coords", "u"):
        np.testing.assert_array_equal(p2_t[k].numpy(), np.asarray(p2_j[k]))
    m_t, m_j = tsg.StructuredGridP1(), jsg.StructuredGridP1()
    v2 = float(m_t.total(p2_t, g2_t))
    assert np.isclose(v2, float(m_j.total(p2_j, g2_j)), rtol=1e-5)
    assert np.isclose(v2, float(m_t.total(
        pt.params_from_numpy(params_np, device=CPU), g_t)), rtol=1e-6)
    # a left-face traction pads by appending, keeping the phase
    g3_j, g3_t = _grids(nx=15, ny=9, split="zigzag",
                        boundaries={"up": 0, "down": 0, "right": 1,
                                    "left": 2})
    assert tsg.pad_lattice_side(g3_t) == "append"
    g4_t, _ = tsg.pad_lattice(g3_t, None, 4)
    g4_j, _ = jsg.pad_lattice(g3_j, None, 4)
    _assert_grid_equal(g4_t, g4_j)


@pytest.mark.parametrize("split", ["up", "zigzag"])
def test_to_trimesh_equal(split):
    """The equivalent TriMesh has JAX's arrays and lattice route, and the
    gather-free energy equals the TriMesh energy."""
    g_j, g_t = _grids(nx=17, ny=9, split=split)
    m_j, m_t = jsg.StructuredGridP1(), tsg.StructuredGridP1()
    tm_j, tm_t = m_j.to_trimesh(g_j), m_t.to_trimesh(g_t, device=CPU)
    for name in ("coords", "connectivity", "geom_boundary_mask",
                 "dirichlet_mask", "neumann_mask", "neumann_edges"):
        np.testing.assert_array_equal(getattr(tm_t, name).numpy(),
                                      np.asarray(getattr(tm_j, name)),
                                      err_msg=name)
    assert_route_equal(tm_t.lattice, tm_j.lattice)
    params_np = _params(g_j, seed=4)
    v_grid = float(m_t.total(pt.params_from_numpy(params_np, device=CPU),
                             g_t))
    flat = pt.params_from_numpy({k: v.reshape(-1, 2)
                                 for k, v in params_np.items()}, device=CPU)
    v_mesh = float(pt.PlaneStressEnergy(model=pt.TriangleP1()).total(
        flat, tm_t))
    assert np.isclose(v_grid, v_mesh, rtol=1e-5), (v_grid, v_mesh)


def test_init_backend_and_device():
    _, g_t = _grids(nx=9, ny=5)
    model = tsg.StructuredGridP1()
    a = model.init(np.random.default_rng(0), g_t, device=CPU)
    b = model.init(np.random.default_rng(0), g_t, device=CPU)
    assert a["u"].shape == (9, 5, 2) and torch.equal(a["u"], b["u"])
    np.testing.assert_allclose(
        a["u"].numpy(),
        1e-5 * np.random.default_rng(0).standard_normal((9, 5, 2)),
        rtol=1e-6)
    c = model.init(torch.Generator().manual_seed(0), g_t, device="cpu")
    assert c["u"].dtype == torch.float32 and c["coords"].shape == (9, 5, 2)
    moved = g_t.to("meta")
    assert moved.quad_mask.device.type == "meta"
    assert all(m.device.type == "meta"
               for m in moved.neumann_edge_masks.values())
    with pytest.raises(ValueError):
        tsg.StructuredGridP1(backend="kernel").total(a, g_t)
    with pytest.raises(ValueError):
        tsg.StructuredGridP1(backend="pallas")
    plain = tsg.StructuredGridP1(backend="plain")
    assert float(plain.total(a, g_t)) == float(model.total(a, g_t))


def test_lbfgs_matches_jax_plateau():
    """150 fixed-step L-BFGS steps (history 10) on a 33x17 zigzag grid
    with a hole from one numpy init: the same plateau as JAX (rtol 1e-4)."""
    g_j, g_t = _grids(nx=33, ny=17, split="zigzag")
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((33, 17, 2))
    coords = np.asarray(g_j.coords)
    m_j, m_t = jsg.StructuredGridP1(), tsg.StructuredGridP1()
    _, lj = ht.run_lbfgs(m_j.total, {"coords": jnp.asarray(coords),
                                     "u": jnp.asarray(u0, jnp.float32)},
                         num_steps=150, memory_size=10, loss_args=(g_j,))
    _, lt = pt.run_lbfgs(m_t.total, pt.params_from_numpy(
        {"coords": coords, "u": u0}, device=CPU), num_steps=150,
        memory_size=10, loss_args=(g_t,))
    assert float(lt[-1]) < float(lt[0])
    assert np.isclose(float(lt[-1]), float(np.asarray(lj)[-1]), rtol=1e-4)


def test_example6_small():
    """The example's whole path at a toy size on the CPU: the energy falls
    and the von Mises stress is finite and positive."""
    from examples.example6_structured_torch import main
    params, losses, vm, final = main(nx=41, ny=21, lbfgs_steps=40,
                                     device=CPU)
    assert params["u"].shape == (41, 21, 2)
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert np.isfinite(final) and final < losses[0]
    assert bool(torch.isfinite(vm).all()) and float(vm.max()) > 0.0


@pytest.mark.parametrize("boundaries", [None, {"up": 0, "down": 0,
                                               "right": 1, "left": 2}])
def test_neumann_edge_mask_alias_matches_jax(boundaries):
    """``StructuredGrid.neumann_edge_mask`` is the right face's segment
    mask (None without one), as in the JAX package."""
    kw = dict(nx=17, ny=9, holes=((1.0, 0.5, 0.2),), boundaries=boundaries)
    g_j = jsg.generate_structured_grid(**kw)
    g_t = tsg.generate_structured_grid(device=CPU, **kw)
    assert (g_t.neumann_edge_mask is None) == (g_j.neumann_edge_mask is None)
    if g_j.neumann_edge_mask is not None:
        np.testing.assert_array_equal(g_t.neumann_edge_mask.numpy(),
                                      np.asarray(g_j.neumann_edge_mask))
