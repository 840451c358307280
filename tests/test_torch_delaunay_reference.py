"""The port on a small exact-rim Delaunay plate with banded tables, held to
the benchmark's plain reference (``fembench/reference``, plain torch in
float64, independent of the port) rather than to the JAX package: the
deployment of the benchmark's ``delaunay_898k`` cells at lc = 0.05.

``TriMesh.from_arrays(..., build_banded=True)`` builds the banded and
paired tables that the full plate gets by default, so in float32 the
energy takes the banded route and, on the CPU, runs its kernels' plain
versions (K4's walk over the recompute windows); in float64 it gathers
through the triangle tables.

* the energy and both gradient groups at a seeded random start, in
  float64 (to rounding) and on the float32 banded route (float32's
  rounding of sums over ~1,700 elements);
* an aux-space PCG solve from rest to relres 1e-6 in float32 against the
  reference's own solution (its stiffness and load, Jacobi-scaled CG to
  1e-11 in float64);
* 60 fixed L-BFGS steps (m = 10) against the reference's plain compact
  L-BFGS replayed from the same start: float64 to rounding, float32 on the
  banded route within what float32 carries over 60 steps.
"""

import numpy as np
import pytest
import torch

import hidenn_fem_tpu_torch as pt
from fembench.meshes import delaunay_holes
from fembench.reference import lbfgs as ref_lbfgs
from fembench.reference.cg import cg
from fembench.reference.p1_plate import P1Plate
from fembench.reference.precision import Precision
from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1

CPU = torch.device("cpu")
E, NU, LOAD = 1e10, 0.3, 9e4
MESH = dict(length=2.0, height=1.0,
            holes=[[0.5, 0.7, 0.12], [1.0, 0.3, 0.15], [1.4, 0.6, 0.1]],
            lc=0.05, smooth_iters=2, reorder=True,
            boundaries={"up": 0, "down": 0, "right": 2, "left": 1})


@pytest.fixture(scope="module")
def arrays():
    return delaunay_holes.arrays(MESH)


def _mesh(arrays, dtype=torch.float32):
    mesh = pt.TriMesh.from_arrays(**arrays, dtype=dtype, build_banded=True,
                                  device=CPU)
    assert mesh.lattice is None and mesh.banded_paired is not None
    return mesh


def _reference(arrays, traction=(LOAD, 0.0)):
    return P1Plate(arrays["coords"], arrays["connectivity"],
                   arrays["geom_boundary_mask"], arrays["dirichlet_mask"],
                   arrays["neumann_edges"], E, NU, traction=traction)


def _energy(dtype=torch.float32):
    return pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=dtype), E=E, nu=NU,
                                F_total=LOAD, traction_length=1.0)


def test_the_recipe_is_the_port_generator(arrays):
    m = pt.generate_mesh_delaunay(holes=[tuple(h) for h in MESH["holes"]],
                                  lc=MESH["lc"], device=CPU)
    for k, v in arrays.items():
        assert np.array_equal(v, getattr(m, k).numpy()), k


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_energy_and_gradients_match_the_reference(arrays, dtype):
    mesh = _mesh(arrays, dtype)
    gen = torch.Generator().manual_seed(3)
    n = mesh.n_nodes
    dc = 2e-4 * torch.randn((n, 2), generator=gen, dtype=torch.float64)
    u = 1e-5 * torch.randn((n, 2), generator=gen, dtype=torch.float64)
    c = torch.tensor(arrays["coords"], dtype=torch.float64) + dc
    p = {"coords": c.to(dtype).requires_grad_(True),
         "u": u.to(dtype).requires_grad_(True)}
    e = _energy(dtype).total(p, mesh)
    gc, gu = torch.autograd.grad(e, [p["coords"], p["u"]])
    ref = _reference(arrays)
    re_, rgc, rgu = ref.value_and_grads(p["coords"].detach(),
                                        p["u"].detach())
    sc, su = ref.gradient_scales(p["coords"].detach(), p["u"].detach())
    # float32 reads 3e-8 (energy) and 1.1e-7 (gradients), float64 3e-16
    tol = 1e-12 if dtype == torch.float64 else 2e-6
    assert abs(float(e.detach()) - float(re_)) <= tol * abs(float(re_))
    for g, rg, s in ((gc, rgc, sc), (gu, rgu, su)):
        gap = torch.linalg.vector_norm(g.double() - rg) \
            / torch.linalg.vector_norm(s)
        assert gap <= tol, gap


def test_aux_pcg_matches_the_reference_solution(arrays):
    mesh = _mesh(arrays)
    energy = _energy()

    def u_loss(p, coords, m):
        return energy.total({"coords": coords, "u": p["u"]}, m)

    up = {"u": torch.zeros((mesh.n_nodes, 2))}
    args = (mesh.coords, mesh)
    bg = StructuredGridP1(E=E, nu=NU)
    pre = pt.build_aux_preconditioner(u_loss, up, args, mesh, bg_model=bg)
    sol, hist = pt.aux_pcg_solve(u_loss, up, args, pre=pre, bg_model=bg,
                                 max_iters=200, tol=1e-6)
    h = hist.numpy()
    iters = int(np.count_nonzero(h))
    assert iters < 200 and h[iters - 1] <= 1e-6

    ref = _reference(arrays)
    K, f, free = ref.stiffness()
    Kd = K.to_dense()
    s = 1.0 / torch.sqrt(torch.diagonal(Kd))
    y, _ = cg(lambda v: s * (K @ (s * v)[:, None])[:, 0], s * f, 1e-11,
              100_000)
    want = torch.zeros(free.shape, dtype=torch.float64)
    want[free] = s * y
    assert torch.allclose(Kd @ want[free], f, rtol=0,
                          atol=1e-9 * f.abs().max())
    u = sol["u"].double().reshape(-1)
    err = torch.linalg.vector_norm(u - want) / torch.linalg.vector_norm(want)
    assert err <= 1e-5, err         # reads 2.5e-7 after 34 iterations


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_lbfgs_follows_the_reference_replay(arrays, dtype):
    """60 fixed steps of compact L-BFGS (m = 10) from u0 = 1e-5 N(0, 1),
    coordinates and displacements: the port's loss history against the
    plain reference's float64 replay from the same (float32) start."""
    mesh = _mesh(arrays, dtype)
    steps, m = 60, 10
    gen = torch.Generator().manual_seed(5)
    u0 = 1e-5 * torch.randn((mesh.n_nodes, 2), generator=gen)
    coords0 = torch.tensor(arrays["coords"])
    params = {"coords": coords0.to(dtype), "u": u0.to(dtype)}
    _, losses = pt.run_lbfgs(_energy(dtype).total, params, num_steps=steps,
                             memory_size=m, loss_args=(mesh,))
    got = losses.double().numpy()

    ref = _reference(arrays)
    n = mesh.n_nodes

    def vg(x):
        e, gc, gu = ref.value_and_grads(x[:2 * n].view(n, 2),
                                        x[2 * n:].view(n, 2))
        return e, torch.cat([gc.reshape(-1), gu.reshape(-1)])

    x0 = torch.cat([coords0.reshape(-1), u0.reshape(-1)]).double()
    want = np.array(ref_lbfgs.replay(vg, x0, m, steps, Precision("float64")))
    gap = np.abs(got - want) / np.abs(want)
    assert np.all(np.isfinite(got))
    if dtype == torch.float64:
        assert gap.max() <= 1e-8, gap.max()     # reads 8.3e-11
    else:
        # float32 reads 3.4e-3 over the first 12 losses and 9.3e-4 at the
        # 60th (the loss falls from ~2e3 to ~-0.7)
        assert gap[:12].max() <= 1e-2 and gap[-1] <= 1e-2, (gap[:12].max(),
                                                            gap[-1])
