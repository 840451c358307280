"""The port on a small hybrid lattice+collar plate built from the
benchmark's frozen recipe (``fembench/meshes/hybrid_holes.py``) by
``hybrid_mesh_from_arrays``, held to the benchmark's plain reference
(``fembench/reference``, plain torch in float64, independent of the port)
rather than to the JAX package: the deployment of the benchmark's
``hybrid_847k`` cell at lc = 0.05.

The energy takes the hybrid route (the plain lattice route on the node
table's prefix, the collar's gather); the reference assembles every
triangle of the same arrays, the collar's included.

* the energy and both gradient groups at a seeded random start, in
  float64 (to rounding) and in float32 (float32's rounding of sums over
  ~1,500 elements);
* an aux-space PCG solve from rest to relres 1e-6 in float32, on the
  lattice-aligned background with rim tables, against the reference's
  own solution (its stiffness and load, Jacobi-scaled CG to 1e-11 in
  float64).
"""

import numpy as np
import pytest
import torch

import hidenn_fem_tpu_torch as pt
from fembench.meshes import hybrid_holes
from fembench.reference.cg import cg
from fembench.reference.p1_plate import P1Plate
from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1
from hidenn_fem_tpu_torch.ops import losses

from torch_port_common import CPU

E, NU, LOAD = 1e10, 0.3, 9e4
MESH = dict(length=2.0, height=1.0,
            holes=[[0.5, 0.7, 0.12], [1.0, 0.3, 0.15], [1.4, 0.6, 0.1]],
            lc=0.05, variant="up", clear=0.6,
            boundaries={"up": 0, "down": 0, "right": 2, "left": 1})


@pytest.fixture(scope="module")
def arrays():
    return hybrid_holes.arrays(MESH)


def _mesh(arrays, dtype=torch.float32):
    mesh = pt.hybrid_mesh_from_arrays(
        **{k: arrays[k] for k in hybrid_holes.SIX}, nx=arrays["nx"],
        ny=arrays["ny"], variant=arrays["variant"], dtype=dtype,
        device=CPU)
    assert mesh.hybrid is not None and mesh.hybrid.extra_conn.shape[0]
    assert mesh.lattice is None and mesh.banded is None
    return mesh


def _reference(arrays, traction=(LOAD, 0.0)):
    return P1Plate(arrays["coords"], arrays["connectivity"],
                   arrays["geom_boundary_mask"], arrays["dirichlet_mask"],
                   arrays["neumann_edges"], E, NU, traction=traction)


def _energy(dtype=torch.float32):
    return pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=dtype), E=E, nu=NU,
                                F_total=LOAD, traction_length=1.0)


@pytest.mark.parametrize("lc,variant", [(0.05, "up"), (0.03, "down")])
def test_the_recipe_is_the_port_generator(lc, variant):
    """The frozen recipe's six arrays, lattice shape and diagonals are the
    port generator's."""
    a = hybrid_holes.arrays(dict(MESH, lc=lc, variant=variant))
    m = pt.generate_mesh_hybrid(holes=[tuple(h) for h in MESH["holes"]],
                                lc=lc, variant=variant, device=CPU)
    assert set(a) == set(hybrid_holes.SIX) | {"nx", "ny", "variant"}
    for k in hybrid_holes.SIX:
        assert np.array_equal(a[k], getattr(m, k).numpy()), k
    r = m.hybrid.lattice
    assert (a["nx"], a["ny"], a["variant"]) == (r.nx, r.ny, variant)


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
    before = losses.route_counts["hybrid"]
    e = _energy(dtype).total(p, mesh)
    assert losses.route_counts["hybrid"] - before == 1
    gc, gu = torch.autograd.grad(e, [p["coords"], p["u"]])
    ref = _reference(arrays)
    re_, rgc, rgu = ref.value_and_grads(p["coords"].detach(),
                                        p["u"].detach())
    sc, su = ref.gradient_scales(p["coords"].detach(), p["u"].detach())
    # float32 reads 6e-8 (energy) and 1.1e-7 (gradients), float64 3e-16
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
    assert pre.lat_kind == "reshape" and pre.rim_corners is not None
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
    assert err <= 1e-5, err         # reads 3.1e-7 after 40 iterations
