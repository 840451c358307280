"""The port's element-sharded energies (``hidenn_fem_tpu_torch/parallel``)
against the JAX package's.

In this process (no group):
* the banded tables with ``block_multiple`` 1, 2, 3 and 4, array-equal to
  the JAX builders' (triangle, paired and strip tables; 3 bands nowhere in
  either package, whose block counts are powers of two);
* ``pad_mesh`` array-equal to JAX's, and its pad rows exact zeros of the
  energy and of every cotangent;
* the plain K4/K5 on one rank's slice of the recompute tables, the rows
  placed at ``row_start``, against JAX's ``_recompute_vg`` and
  ``_recompute_bwd`` in interpret mode (k = 3, 4, 6): energy rtol 1e-5,
  rows rtol 1e-5 + 1e-5 x max|g|; the slices' energies sum to the whole.

Spawned gloo groups of 3 and 4 CPU ranks (``tests/torch_sharded_common``)
run ``shard_map_energy`` (padded gather route, f32 and f64),
``shard_map_banded_energy`` (paired tables rebanded for 4 ranks; 3 ranks
raise, as in JAX), ``sharded_lattice_energy`` (an identity lattice with
holes in f64, a renumbered lattice, a hybrid mesh with a body force, in
f32) and 10 sharded ``run_lbfgs`` steps (gather and lattice in
f64, banded in f32), every rank's values bit-equal to rank 0's, against
JAX's sharded functions over ``jax.devices("cpu")[:4]``: f32 energy rtol
1e-5 and gradients atol 1e-5 x max|g|, f64 rtol 1e-10 on both; the
10-step loss histories rtol 1e-9 in f64 and 5e-3 in f32 (the fixed step
amplifies f32 rounding from step to step).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh import banded as jb
from hidenn_fem_tpu.ops import banded_energy as jbe
from hidenn_fem_tpu.parallel import sharding as jsh
from hidenn_fem_tpu.parallel.sharded_lattice import \
    sharded_lattice_energy as j_sharded_lattice
from hidenn_fem_tpu_torch.mesh import banded as pb
from hidenn_fem_tpu_torch.ops import banded_energy as pbe
from hidenn_fem_tpu_torch.ops import element_energy as pee
from hidenn_fem_tpu_torch.parallel import sharding as psh

from torch_port_common import CPU, assert_close, port_mesh, random_params
from torch_sharded_common import Groups, mesh_arrays

E, NU, W_SUM = 10e9, 0.3, 0.5
HOLE = ((1.0, 0.5, 0.25),)
# 10 fixed L-BFGS steps in f32: the first step jumps the energy ~1e6-fold
# and each package's rounding of it carries on (PERF.md section 2's f32
# spread; measured 4.6e-3 on the gather route here)
F32_HISTORY_RTOL = 5e-3


def _jax_dmesh(n):
    return Mesh(np.array(jax.devices("cpu")[:n]), (jsh.ELEM_AXIS,))


# ------------------------------------------------------------ in-process
@functools.lru_cache(maxsize=None)
def _plate():
    return dataclasses.replace(ht.proxy_plate_mesh(nx=33, ny=17),
                               lattice=None)


def _build(pkg, kind, conn, n, inc, bm, window_limit=300, **kw):
    """``kind`` tables (triangle, paired or strip) of the JAX package or
    the port (``kw``: the port's ``device``)."""
    if kind == "triangle":
        return pkg.build_banded_assembly(conn, n, inc,
                                         window_limit=window_limit,
                                         block_multiple=bm, **kw)
    build = {"paired": pkg.build_paired_assembly,
             "strip": pkg.build_striped_assembly}[kind]
    return build(conn, n, window_limit=window_limit, block_multiple=bm,
                 **kw)


@pytest.mark.parametrize("bm", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["triangle", "paired", "strip"])
def test_block_multiple_tables_equal_jax(kind, bm):
    mesh = _plate()
    conn = np.asarray(mesh.connectivity)
    n = mesh.n_nodes
    inc = np.asarray(mesh.incidence)
    want = _build(jb, kind, conn, n, inc, bm)
    got = _build(pb, kind, conn, n, inc, bm, device=CPU)
    assert (got is None) == (want is None)
    if want is None:
        assert bm == 3
        return
    assert want.starts.shape[0] % bm == 0
    assert want.re_nstarts.shape[0] % bm == 0
    for f in ("starts", "conn_rel", "ct_starts", "inc_rel", "re_nstarts",
              "re_estarts", "re_conn_rel", "re_inc_rel", "re_own_lo",
              "re_own_hi"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f
        if b is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f)
    for f in ("wnode", "wct", "re_wnode", "re_ew", "k"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("n_shards", [3, 4, 7, 16])
def test_pad_mesh_equal_jax_and_pads_are_exact_zeros(n_shards):
    mj = ht.generate_mesh(nx=17, ny=9, holes=list(HOLE))
    mt = port_mesh(dataclasses.replace(mj, lattice=None))
    pj = jsh.pad_mesh(mj, n_shards)
    ptm = psh.pad_mesh(mt, n_shards)
    assert ptm.lattice is None and pj.lattice is None
    for a, b in zip(ptm.astuple(), pj.astuple()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert ptm.n_elements % n_shards == 0
    assert ptm.n_neumann_edges % n_shards == 0
    # the pad rows give exact zeros: energy, cotangents, edge work
    params = pt.params_from_numpy(random_params(mj), device=CPU)
    model = pt.TriangleP1()
    node = model.packed_nodes(params, ptm)
    pads = ptm.connectivity[mt.n_elements:]
    assert pads.shape[0] == ptm.n_elements - mt.n_elements
    g = node[pads.long()]
    assert torch.all(pee.element_energy_plain(g, E, NU, W_SUM) == 0)
    ct = torch.ones(())
    assert torch.all(pee.element_cotangent_plain(g, ct, E, NU, W_SUM) == 0)
    pad_edges = ptm.neumann_edges[mt.n_neumann_edges:]
    if pad_edges.shape[0]:
        energy = pt.PlaneStressEnergy(model=model)
        p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
        w = energy.edge_energy(p, dataclasses.replace(
            ptm, neumann_edges=pad_edges))
        assert float(w.detach()) == 0.0
        for gr in torch.autograd.grad(w, [p["coords"], p["u"]]):
            assert torch.all(gr == 0)


def _jax_slice(ba, rank, size):
    """The rank slice that JAX's shard_map_banded_energy builds in its
    body (parallel/sharding.py:257-266), and its row_start."""
    b = ba.starts.shape[0] // size
    br = ba.re_nstarts.shape[0] // size
    f, r = slice(rank * b, (rank + 1) * b), slice(rank * br, (rank + 1) * br)
    has_own = ba.re_own_lo is not None
    loc = jb.BandedAssembly(
        starts=ba.starts[f], conn_rel=ba.conn_rel[f], ct_starts=None,
        inc_rel=None, re_nstarts=ba.re_nstarts[r], re_estarts=None,
        re_conn_rel=ba.re_conn_rel[r], re_inc_rel=ba.re_inc_rel[r],
        re_own_lo=ba.re_own_lo[r] if has_own else None,
        re_own_hi=ba.re_own_hi[r] if has_own else None,
        wnode=ba.wnode, wct=0, re_wnode=ba.re_wnode, re_ew=ba.re_ew, k=ba.k)
    return loc, rank * br * ba.re_inc_rel.shape[1]


@pytest.mark.parametrize("k,size,window_limit", [
    pytest.param(3, 4, 300, id="3"), pytest.param(4, 4, 300, id="4"),
    pytest.param(6, 4, 300, id="6"),
    # 16 slices of 128 node blocks of 5 rows: the last slice places no row
    pytest.param(4, 16, 100, id="4-empty-slice"),
    # other rank counts (the block counts are powers of two: no 3 ranks)
    pytest.param(3, 2, 300, id="3-2-ranks"),
    pytest.param(4, 2, 300, id="4-2-ranks"),
    pytest.param(6, 8, 300, id="6-8-ranks")])
def test_rows_plain_k4_k5_match_jax_interpret(k, size, window_limit):
    mesh = _plate()
    conn = np.asarray(mesh.connectivity)
    n = mesh.n_nodes
    inc = np.asarray(mesh.incidence)
    kind = {3: "triangle", 4: "paired", 6: "strip"}[k]
    ja = _build(jb, kind, conn, n, inc, size, window_limit)
    ta = _build(pb, kind, conn, n, inc, size, window_limit, device=CPU)
    assert ja.k == k and ja.re_own_lo is not None
    params = random_params(mesh, seed=3)
    tp = pt.params_from_numpy(params, device=CPU)
    mt = port_mesh(mesh)
    node_t = pt.TriangleP1().packed_nodes(tp, mt).contiguous()
    node_j = jnp.asarray(node_t.numpy())
    ct = 0.75
    vg = jax.jit(lambda nd, b, rs: jbe._recompute_vg(nd, b, E, NU, W_SUM,
                                                     True, rs))
    bwd = jax.jit(lambda nd, b, rs: jbe._recompute_bwd(
        nd, b, E, NU, W_SUM, True, jnp.float32(ct), rs))
    whole, _ = pbe.banded_vg_plain(node_t, ta, E, NU, W_SUM)
    total, empty = 0.0, 0
    for rank in range(size):
        jl, jrs = _jax_slice(ja, rank, size)
        tl, trs = psh.rank_tables(ta, rank, size)
        assert trs == jrs
        placed = pbe._placed_rows(
            tl.re_inc_rel.shape[0] * tl.re_inc_rel.shape[1], trs, n)
        ej, gj = vg(node_j, jl, jnp.int32(jrs))
        et, gt = pbe.banded_vg_plain(node_t, tl, E, NU, W_SUM, trs)
        assert_close(float(et), float(ej), rtol=1e-5, what="energy")
        gj = np.asarray(gj)
        if placed == 0:         # table padding only: no row placed
            empty += 1
            assert not gt.any() and not gj.any()
        assert_close(gt.numpy(), gj, rtol=1e-5,
                     atol=1e-5 * np.abs(gj).max(), what="K4 rows")
        # the rows outside the slice stay zero in both
        assert np.all(gt.numpy()[:trs] == 0) and np.all(gj[:trs] == 0)
        total += float(et)
        nl = dataclasses.replace(jl, re_own_lo=None, re_own_hi=None)
        bj = np.asarray(bwd(node_j, nl, jnp.int32(jrs)))
        bt = pbe.banded_bwd_plain(
            node_t, dataclasses.replace(tl, re_own_lo=None, re_own_hi=None),
            torch.tensor(ct), E, NU, W_SUM, trs)
        assert_close(bt.numpy(), bj, rtol=1e-5,
                     atol=1e-5 * np.abs(bj).max(), what="K5 rows")
    assert_close(total, float(whole), rtol=1e-5, what="sum over slices")
    assert empty == (1 if size == 16 else 0)


def test_sharded_banded_refuses_indivisible_tables():
    mesh_t = port_mesh(_plate())
    tri = psh.reband_for_shards(mesh_t, 2, window_limit=300)
    ba = tri.banded_paired
    assert ba.starts.shape[0] % 2 == 0
    blocks = {ba.starts.shape[0], ba.re_nstarts.shape[0]}
    odd = next(d for d in (3, 5, 6, 7) if any(b % d for b in blocks))
    loss = psh.shard_map_banded_energy(
        pt.PlaneStressEnergy(model=pt.TriangleP1()),
        psh.DeviceMesh(group=None, rank=0, size=odd, device=CPU))
    params = pt.params_from_numpy(random_params(_plate()), device=CPU)
    with pytest.raises(ValueError, match="not divisible by the device"):
        loss(params, tri)


# ------------------------------------------------------- spawned groups
def _hybrid_jax():
    return ht.generate_mesh_hybrid(holes=list(HOLE), lc=0.06)


def _cases():
    """[(case, arrays, JAX mesh)]: each case's spec for the workers."""
    plate = ht.generate_mesh(nx=17, ny=9, holes=list(HOLE))
    lat = ht.generate_mesh(nx=33, ny=17, holes=list(HOLE),
                           keep_dead_nodes=True)
    renum = ht.generate_mesh(nx=33, ny=17, holes=list(HOLE))
    hyb = _hybrid_jax()
    out = []

    def add(case, mesh):
        out.append((case, mesh_arrays(mesh, random_params(mesh, seed=1)),
                    mesh))

    gather = dataclasses.replace(plate, lattice=None)
    add(dict(name="gather32", fn="energy", dtype="float32"), gather)
    add(dict(name="gather64", fn="energy", dtype="float64", steps=10),
        gather)
    add(dict(name="banded", fn="banded", dtype="float32", steps=10,
             window_limit=300), _plate())
    add(dict(name="lattice64", fn="lattice", dtype="float64", steps=10), lat)
    add(dict(name="renumbered", fn="lattice", dtype="float32"), renum)
    hy = dict(holes=[list(h) for h in HOLE], lc=0.06)
    add(dict(name="hybrid_body", fn="lattice", dtype="float32", hybrid=hy,
             body_force=True), hyb)
    return out


CASES = ("gather32", "gather64", "banded", "lattice64", "renumbered",
         "hybrid_body")


class _Spawned:
    """The groups of 3 and 4 ranks and, computed once a case, the JAX
    references over 4 CPU devices."""

    def __init__(self, folder):
        self.cases = {c["name"]: (c, a, m) for c, a, m in _cases()}
        self.groups = Groups(folder, [(c, a) for c, a, _ in
                                      self.cases.values()], worlds=(3, 4))
        self.refs = {}

    def reference(self, name):
        if name not in self.refs:
            self.refs[name] = _jax_reference(*self.cases[name])
        return self.refs[name]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    s = _Spawned(tmp_path_factory.mktemp("sharding"))
    yield s
    s.groups.close()


def _jax_body_force(x):
    return jnp.stack([jnp.sin(x[:, 0]) * 1e4, x[:, 1] * 2e4], axis=1)


def _jax_reference(case, arrays, mesh):
    """JAX's sharded value, gradients and (with steps) loss history."""
    f64 = case["dtype"] == "float64"
    with jax.enable_x64(f64):
        dtype = jnp.float64 if f64 else jnp.float32
        if f64:
            mesh = ht.TriMesh.from_arrays(
                *[np.asarray(a) for a in mesh.astuple()], dtype=dtype,
                build_banded=False,
                build_lattice=mesh.lattice is not None)
        energy = ht.PlaneStressEnergy(
            model=ht.TriangleP1(dtype=dtype), E=E, nu=NU,
            body_force=_jax_body_force if case.get("body_force") else None)
        dm = _jax_dmesh(4)
        if case["fn"] == "energy":
            loss_fn, tri = jsh.shard_map_energy(energy, dm), \
                jsh.pad_mesh(mesh, 4)
        elif case["fn"] == "banded":
            loss_fn = jsh.shard_map_banded_energy(energy, dm)
            tri = jsh.reband_for_shards(mesh, 4,
                                        window_limit=case["window_limit"])
        else:
            loss_fn, tri = j_sharded_lattice(energy, dm), mesh
        params = {"coords": jnp.asarray(arrays["p_coords"], dtype),
                  "u": jnp.asarray(arrays["p_u"], dtype)}
        v, g = jax.jit(jax.value_and_grad(loss_fn))(params, tri)
        out = {"energy": float(v), "g_coords": np.asarray(g["coords"]),
               "g_u": np.asarray(g["u"])}
        if case.get("steps"):
            _, losses = ht.run_lbfgs(loss_fn, params,
                                     num_steps=case["steps"],
                                     loss_args=(tri,))
            out["losses"] = np.asarray(losses)
    return out


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("name", CASES)
def test_sharded_energy_matches_jax(spawned, name, world):
    case, _, mesh = spawned.cases[name]
    got = spawned.groups.case(world, name)
    if case["fn"] == "banded" and world == 3:
        # 3 divides no block count of either package: both raise
        assert "not bandable" in str(got["error"])
        with pytest.raises(ValueError, match="not bandable"):
            jsh.reband_for_shards(mesh, 3, window_limit=300)
        return
    assert "error" not in got, str(got.get("error"))
    want = spawned.reference(name)
    f64 = case["dtype"] == "float64"
    tol = 1e-10 if f64 else 1e-5
    assert_close(got["energy"], want["energy"], rtol=tol, what="energy")
    for k in ("g_coords", "g_u"):
        w = want[k]
        assert_close(got[k], w, rtol=1e-10 if f64 else 0.0,
                     atol=tol * np.abs(w).max(), what=k)
    if case.get("steps"):
        assert got["losses"].shape == (case["steps"],)
        assert_close(got["losses"], want["losses"],
                     rtol=1e-9 if f64 else F32_HISTORY_RTOL,
                     what="10-step loss history")


def test_convert_carries_rebanded_tables_and_padded_meshes():
    """A JAX mesh rebanded for 4 ranks and a JAX mesh padded for 3 carry
    across ``mesh_from_numpy`` as they are: tables and padded arrays equal,
    and the port's sharded energies over them (as one rank) equal its
    energy on the plain mesh."""
    mj = _plate()
    rebanded = jsh.reband_for_shards(mj, 4, window_limit=300)
    padded = jsh.pad_mesh(mj, 3)
    mt = pt.mesh_from_numpy(rebanded, device=CPU, build_lattice=False)
    for f in ("starts", "conn_rel", "re_nstarts", "re_conn_rel",
              "re_inc_rel", "re_own_lo", "re_own_hi"):
        np.testing.assert_array_equal(
            getattr(mt.banded_paired, f).numpy(),
            np.asarray(getattr(rebanded.banded_paired, f)), err_msg=f)
    assert mt.banded is None and mt.banded_paired.k == 4
    pm = pt.mesh_from_numpy(padded, device=CPU, build_lattice=False,
                            build_incidence=False)
    assert pm.incidence is None and pm.n_elements % 3 == 0
    np.testing.assert_array_equal(pm.connectivity.numpy(),
                                  np.asarray(padded.connectivity))
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())
    params = pt.params_from_numpy(random_params(mj), device=CPU)
    one = psh.device_mesh(device="cpu")
    want = float(energy.total(params, port_mesh(mj)))
    for loss_fn, tri in ((psh.shard_map_banded_energy(energy, one), mt),
                         (psh.shard_map_energy(energy, one), pm)):
        assert_close(float(loss_fn(params, tri)), want, rtol=1e-6)
