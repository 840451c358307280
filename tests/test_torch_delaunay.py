"""The port's irregular-mesh generators against the JAX package's: the
Delaunay generator (constant and graded size fields), the gmsh assembly
and generator driven by a fake gmsh module (gmsh is not installed), and
the ``generate_mesh_unstructured`` dispatch, each array-equal and on the
same route; then the slice as a whole on a small Delaunay mesh carrying
banded tables: the total energy with both gradient groups, and a short
L-BFGS solve.

Tolerances: meshes exactly equal; f32 rtol 1e-5 on energies and atol
1e-5 x max|grad| on gradients (sums in another order, see
``tests/test_torch_losses.py``); the 10-step solve's losses rtol 1e-9 in
f64 and 5e-3 in f32 (see ``test_delaunay_lbfgs_matches_jax``).
"""

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh import banded as jb
from hidenn_fem_tpu.mesh import delaunay as jd
from hidenn_fem_tpu.mesh import gmsh_backend as jg
from hidenn_fem_tpu_torch.mesh import banded as pb
from hidenn_fem_tpu_torch.mesh import delaunay as pd
from hidenn_fem_tpu_torch.mesh import gmsh_backend as pg

from test_gmsh_backend import _FakeGmsh, _toy_mesh
from torch_port_common import CPU, assert_close, random_params, to_jax, \
    to_torch

HOLES = ((0.5, 0.7, 0.12), (1.0, 0.3, 0.15), (1.4, 0.6, 0.1))
FIELDS = ("coords", "connectivity", "geom_boundary_mask", "dirichlet_mask",
          "neumann_mask", "neumann_edges", "incidence", "fused_connectivity",
          "fused_incidence")


def assert_mesh_equal(port, jax_mesh):
    """Same arrays, and the same routes (lattice, banded, hybrid)."""
    for name in FIELDS:
        a, b = getattr(port, name), getattr(jax_mesh, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    for name in ("lattice", "banded", "banded_paired", "hybrid"):
        assert (getattr(port, name) is None) == \
            (getattr(jax_mesh, name, None) is None), name


def _graded(p):
    return 0.06 + 0.08 * np.asarray(p)[:, 0] / 2.0


@pytest.mark.parametrize("kw", [
    dict(lc=0.09), dict(lc=0.12, holes=()), dict(lc=_graded),
    dict(lc=0.1, reorder=False),
    dict(lc=0.1, holes=((1.0, 0.5, 0.3),),
         boundaries={"up": 2, "down": 1, "left": 0, "right": 0})],
    ids=["holes", "no_holes", "graded", "raw_order", "boundaries"])
def test_delaunay_mesh_equal_jax(kw):
    assert_mesh_equal(pd.generate_mesh_delaunay(device=CPU, **kw),
                      jd.generate_mesh_delaunay(**kw))


@pytest.mark.parametrize("reorder", [False, True])
def test_assemble_gmsh_mesh_equal_jax(reorder):
    points, _, tags, tri_tags = _toy_mesh()
    kw = dict(node_tags=tags, points=points, tri_tags=tri_tags,
              boundary_node_tags=tags[points[:, 0] < 1e-9],
              holes=((1.0, 0.5, 0.25),),
              boundaries={"up": 0, "down": 0, "right": 2, "left": 1},
              length=2.0, height=1.0, reorder=reorder)
    assert_mesh_equal(pg.assemble_gmsh_mesh(device=CPU, **kw),
                      jg.assemble_gmsh_mesh(**kw))


@pytest.fixture
def fake_gmsh(monkeypatch):
    fake = _FakeGmsh()
    monkeypatch.setitem(sys.modules, "gmsh", fake)
    return fake


def test_generate_mesh_gmsh_equal_jax(fake_gmsh):
    kw = dict(length=2.0, height=1.0, holes=(),
              boundaries={"up": 0, "down": 0, "right": 2, "left": 1},
              lc=0.25)
    assert pg.have_gmsh() and jg.have_gmsh()
    assert_mesh_equal(pg.generate_mesh_gmsh(device=CPU, **kw),
                      jg.generate_mesh_gmsh(**kw))
    assert [c[0] for c in fake_gmsh.calls].count("initialize") == 2


def test_generate_mesh_gmsh_needs_gmsh(monkeypatch):
    monkeypatch.setitem(sys.modules, "gmsh", None)     # import fails
    assert not pg.have_gmsh() and not jg.have_gmsh()
    with pytest.raises(ImportError):
        pg.generate_mesh_gmsh(lc=0.25, device=CPU)


@pytest.mark.parametrize("kw", [
    dict(holes=((1.0, 0.5, 0.25),), lc=0.1),
    dict(holes=((1.0, 0.5, 0.25),), lc=0.1, prefer_hybrid=False),
    dict(holes=((1.0, 0.5, 0.25),), lc=lambda p: 0.1 + 0 * p[:, 0]),
    dict(holes=((0.2, 0.2, 0.19),), lc=0.1)],
    ids=["hybrid", "opt_out", "callable_lc", "hole_at_boundary"])
def test_unstructured_dispatch_equal_jax(kw):
    """No gmsh: hybrid when the geometry qualifies, else Delaunay, in both
    packages."""
    got = pd.generate_mesh_unstructured(device=CPU, **kw)
    want = jd.generate_mesh_unstructured(**kw)
    assert_mesh_equal(got, want)
    assert (got.hybrid is not None) == (kw.get("prefer_hybrid", True)
                                        and kw["lc"] == 0.1
                                        and kw["holes"][0][2] == 0.25)


def test_unstructured_dispatch_prefers_hybrid_over_gmsh(fake_gmsh):
    kw = dict(length=2.0, height=1.0, holes=(),
              boundaries={"up": 0, "down": 0, "right": 2, "left": 1},
              lc=0.25)
    got = pd.generate_mesh_unstructured(device=CPU, **kw)
    assert got.hybrid is not None                        # no gmsh call
    assert_mesh_equal(got, jd.generate_mesh_unstructured(**kw))
    assert not fake_gmsh.calls
    got = pd.generate_mesh_unstructured(prefer_hybrid=False, device=CPU,
                                        **kw)
    assert_mesh_equal(got, jd.generate_mesh_unstructured(
        prefer_hybrid=False, **kw))
    assert got.hybrid is None and fake_gmsh.calls       # through gmsh


@pytest.fixture(scope="module")
def banded_delaunay():
    """A Delaunay plate with both packages' banded tables (window 300,
    paired tables preferred): the slice's route at a tier-1 size."""
    mj = jd.generate_mesh_delaunay(holes=HOLES, lc=0.08)
    conn, n = np.asarray(mj.connectivity), mj.n_nodes
    inc = np.asarray(mj.incidence)
    mt = pt.mesh_from_numpy(mj, device=CPU, build_banded=False)
    assert mt.lattice is None and mj.lattice is None
    return (dataclasses.replace(
                mj, banded=jb.build_banded_assembly(conn, n, inc,
                                                    window_limit=300),
                banded_paired=jb.build_paired_assembly(conn, n,
                                                       window_limit=300)),
            dataclasses.replace(
                mt, banded=pb.build_banded_assembly(conn, n, inc,
                                                    window_limit=300,
                                                    device=CPU),
                banded_paired=pb.build_paired_assembly(conn, n,
                                                       window_limit=300,
                                                       device=CPU)))


def test_delaunay_total_matches_jax(banded_delaunay):
    """total() on the banded route (the port's plain K4 with a gradient)
    against the JAX package's banded kernels in interpret mode."""
    mj, mt = banded_delaunay
    params_np = random_params(mj, seed=11)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(),
                              backend="pallas_interpret")
    vj, gj = jax.value_and_grad(lambda p: je.total(p, mj))(to_jax(params_np))
    te = pt.PlaneStressEnergy(model=pt.TriangleP1())
    p = to_torch(params_np, requires_grad=True)
    vt = te.total(p, mt)
    gc, gu = torch.autograd.grad(vt, [p["coords"], p["u"]])
    assert_close(float(vt.detach()), float(vj), rtol=1e-5)
    for name, got in (("coords", gc), ("u", gu)):
        want = np.asarray(gj[name])
        assert_close(got.numpy(), want, rtol=1e-5,
                     atol=1e-5 * np.abs(want).max(), what=name)


@pytest.mark.parametrize("f64", [False, True], ids=["f32", "f64"])
def test_delaunay_lbfgs_matches_jax(banded_delaunay, f64):
    """Ten L-BFGS steps from u0 = 1e-5 N(0,1) on the banded mesh.

    f64: the port (its plain banded gather, as the JAX package routes
    float64) against the JAX package under ``jax.enable_x64`` on its XLA
    gather route (its banded gather does not run under x64: ROADMAP
    Queue C), rtol 1e-9 (measured 2.4e-11).  f32: the port's banded route
    against the JAX package's within the f32 spread, rtol 5e-3: the
    first fixed step jumps to ~2e10 and each package's f32 rounding of
    it carries into the later steps (both lie up to 1.7e-3 from the f64
    run here)."""
    mj, mt = banded_delaunay
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mj.n_nodes, 2))
    jdt, tdt = ((jnp.float64, torch.float64) if f64
                else (jnp.float32, torch.float32))
    arrays = [np.asarray(a) for a in mj.astuple()]
    with jax.enable_x64(f64):
        if f64:
            mj = ht.TriMesh.from_arrays(*arrays, dtype=jdt,
                                        build_lattice=False,
                                        build_banded=False)
        je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jdt))
        _, lj = ht.run_lbfgs(je.total, {"coords": mj.coords,
                                        "u": jnp.asarray(u0, jdt)},
                             num_steps=10, loss_args=(mj,))
        lj = np.asarray(lj)
    if f64:
        mt = dataclasses.replace(pt.mesh_from_numpy(
            mj, device=CPU, dtype=tdt, build_banded=False), banded=mt.banded,
            banded_paired=mt.banded_paired)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=tdt))
    _, lt = pt.run_lbfgs(te.total, pt.params_from_numpy(
        {"coords": mt.coords.numpy(), "u": u0}, device=CPU, dtype=tdt),
        num_steps=10,
        loss_args=(mt,))
    lt = lt.numpy()
    assert np.all(np.isfinite(lt)) and lt[-1] < lt[0]
    assert_close(lt, lj, rtol=1e-9 if f64 else 5e-3)
