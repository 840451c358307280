"""The port's banded route against the JAX package's, on the same numpy
inputs: the banded, paired and striped tables (array-equal), the plain
K3/K4/K5 paths against JAX's ``banded_element_energy`` in Pallas interpret
mode, the float64 banded route against JAX's XLA route, the route each
configuration takes, and the windowed-gather probe K8.

Meshes are small (``window_limit=300`` so that several blocks exist), as
in ``tests/test_banded_energy.py``.  Tolerances: f32 rtol 1e-5 on
energies and atol 1e-5 x max|grad| on gradients (sums in another order;
coordinate gradients are sums of cancelling terms, see
``tests/test_torch_losses.py``); f64 rtol 1e-10 on energies, rtol 1e-8
with atol 1e-11 x max|grad| on gradients.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh import banded as jb
from hidenn_fem_tpu.ops import assembly as jasm
from hidenn_fem_tpu.ops import banded_energy as jbe
from hidenn_fem_tpu_torch.mesh import banded as pb
from hidenn_fem_tpu_torch.ops import assembly as pasm
from hidenn_fem_tpu_torch.ops import banded_energy as pbe
from hidenn_fem_tpu_torch.ops import window_gather as pwg

from torch_port_common import CPU, assert_close, random_params, to_jax, \
    to_torch

WINDOW = 300
TABLES = ("starts", "conn_rel", "ct_starts", "inc_rel", "re_nstarts",
          "re_estarts", "re_conn_rel", "re_inc_rel", "re_own_lo",
          "re_own_hi")
STATIC = ("wnode", "wct", "re_wnode", "re_ew", "k")
NO_OWN = dict(re_own_lo=None, re_own_hi=None)
NO_RECOMPUTE = dict(re_nstarts=None, re_estarts=None, re_conn_rel=None,
                    re_inc_rel=None, re_own_lo=None, re_own_hi=None)


@pytest.fixture(scope="module")
def meshes():
    return {"plate": dataclasses.replace(ht.proxy_plate_mesh(nx=33, ny=17),
                                         lattice=None),
            "delaunay": ht.generate_mesh_delaunay(lc=0.09)}


def _tables(pkg, mesh, k):
    """(package's) banded tables of layout k at window_limit 300."""
    conn = np.asarray(mesh.connectivity)
    n = mesh.n_nodes
    kw = {"device": CPU} if pkg is pb else {}
    if k == 3:
        return pkg.build_banded_assembly(conn, n, np.asarray(mesh.incidence),
                                         window_limit=WINDOW, **kw)
    build = (pkg.build_paired_assembly if k == 4
             else pkg.build_striped_assembly)
    return build(conn, n, window_limit=WINDOW, **kw)


def assert_tables_equal(port, jax_tables):
    assert (port is None) == (jax_tables is None)
    if port is None:
        return
    for name in TABLES:
        a, b = getattr(port, name), getattr(jax_tables, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=name)
    for name in STATIC:
        assert getattr(port, name) == getattr(jax_tables, name), name


def _mesh_pair(mesh_j, k, change=None, dtype=torch.float32):
    """The JAX mesh and the port's, each with its package's tables of
    layout k (k=3: triangle tables only; 4 or 6 as the preferred set),
    ``change`` applied to the preferred set on both sides."""
    jt, pt3 = _tables(jb, mesh_j, 3), _tables(pb, mesh_j, 3)
    jp = pp = None
    if k != 3:
        jp, pp = _tables(jb, mesh_j, k), _tables(pb, mesh_j, k)
    if change:
        if k == 3:
            jt, pt3 = (dataclasses.replace(jt, **change),
                       dataclasses.replace(pt3, **change))
        else:
            jp, pp = (dataclasses.replace(jp, **change),
                      dataclasses.replace(pp, **change))
    mesh_t = pt.mesh_from_numpy(mesh_j, device=CPU, dtype=dtype,
                                build_lattice=False, build_banded=False)
    return (dataclasses.replace(mesh_j, banded=jt, banded_paired=jp),
            dataclasses.replace(mesh_t, banded=pt3, banded_paired=pp))


@pytest.mark.parametrize("k", [3, 4, 6])
@pytest.mark.parametrize("which", ["plate", "delaunay"])
def test_tables_equal_jax(meshes, which, k):
    jt = _tables(jb, meshes[which], k)
    pt_ = _tables(pb, meshes[which], k)
    assert pt_.n_element_blocks > 1 and pt_.re_own_lo is not None
    assert_tables_equal(pt_, jt)


@pytest.mark.parametrize("which", ["plate", "delaunay"])
def test_pair_and_strip_connectivity_equal_jax(meshes, which):
    conn = np.asarray(meshes[which].connectivity)
    np.testing.assert_array_equal(pb.pair_connectivity(conn),
                                  np.asarray(jb.pair_connectivity(conn)))
    (ps, pk), (js, jk) = (pb.strip_connectivity(conn),
                          jb.strip_connectivity(conn))
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(pk, jk)
    n = meshes[which].n_nodes
    np.testing.assert_array_equal(pb._incidence_k(ps, n, keep=pk),
                                  jb._incidence_k(js, n, keep=jk))
    # fewer than half the triangles pair: no tables on either side
    lone = np.arange(30).reshape(10, 3)
    assert pb.pair_connectivity(lone) is None
    assert jb.pair_connectivity(lone) is None


@pytest.mark.parametrize("estarts, ew, ne", [
    ([0, 3, 7, 12], 6, 18), ([0, 5, 11], 6, 17), ([0, 2, 2, 9], 4, 13),
    ([0, 10], 6, 16)])
def test_ownership_intervals_equal_jax(estarts, ew, ne):
    got = pb._ownership_intervals(np.asarray(estarts), ew, ne)
    want = jb._ownership_intervals(np.asarray(estarts), ew, ne)
    assert (got is None) == (want is None)
    if want is not None:
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_reorder_mesh_equal_jax():
    mesh_j = ht.generate_mesh(nx=25, ny=13, holes=((1.0, 0.5, 0.2),))
    mesh_t = pt.generate_mesh(nx=25, ny=13, holes=((1.0, 0.5, 0.2),),
                              device=CPU)
    conn = np.asarray(mesh_j.connectivity)
    np.testing.assert_array_equal(pb.rcm_node_order(conn, mesh_j.n_nodes),
                                  jb.rcm_node_order(conn, mesh_j.n_nodes))
    rj = jb.reorder_mesh(mesh_j, build_banded=True)
    rt = pb.reorder_mesh(mesh_t, build_banded=True)
    for name in ("coords", "connectivity", "geom_boundary_mask",
                 "dirichlet_mask", "neumann_mask", "neumann_edges",
                 "incidence"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)),
                                      err_msg=name)
    assert_tables_equal(rt.banded, rj.banded)
    assert_tables_equal(rt.banded_paired, rj.banded_paired)
    assert (rt.lattice is None) == (rj.lattice is None)


@pytest.mark.parametrize("build, env", [
    (True, {}), ("nopair", {}), (True, {"HDNN_NO_PAIR": "1"}),
    (True, {"HDNN_STRIPS": "1"}), ("auto", {}), (False, {})])
def test_from_arrays_builds_the_jax_tables(monkeypatch, meshes, build, env):
    """``build_banded`` and the environment pick the same tables in both
    packages (``auto`` builds none below 250,000 gather rows)."""
    for name in ("HDNN_NO_PAIR", "HDNN_STRIPS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    m = meshes["plate"]
    arrays = [np.asarray(a) for a in m.astuple()]
    mj = ht.TriMesh.from_arrays(*arrays, build_banded=build,
                                build_lattice=False)
    mt = pt.TriMesh.from_arrays(*arrays, build_banded=build,
                                build_lattice=False, device=CPU)
    assert_tables_equal(mt.banded, mj.banded)
    assert_tables_equal(mt.banded_paired, mj.banded_paired)
    if build is True and not env:
        assert mt.banded_paired.k == 4
    if env.get("HDNN_STRIPS"):
        assert mt.banded_paired.k == 6


class _Spy:
    """Counts the calls of a module function (and still calls it)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        monkeypatch.setattr(module, name, wrapped)


CASES = {
    "k3": ("plate", 3, None), "k4": ("plate", 4, None),
    "k6": ("plate", 6, None), "k4_delaunay": ("delaunay", 4, None),
    "k4_no_ownership": ("plate", 4, NO_OWN),
    "k4_no_recompute": ("plate", 4, NO_RECOMPUTE),
    "k3_no_recompute": ("delaunay", 3, NO_RECOMPUTE),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_banded_energy_matches_jax_interpret(monkeypatch, meshes, case):
    """PlaneStressEnergy.domain_energy on the banded route: the port's
    plain K3/K4/K5 (CPU, backend "auto") against the JAX package's
    kernels in interpret mode; value, both gradient groups, and the value
    under no_grad (K3).  The port runs K4 when the tables have ownership,
    else K3 then K5, as the JAX package's custom_vjp does."""
    which, k, change = CASES[case]
    mesh_j, mesh_t = _mesh_pair(meshes[which], k, change)
    params_np = random_params(mesh_j, seed=3)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(),
                              backend="pallas_interpret")
    vj, gj = jax.value_and_grad(lambda p: je.domain_energy(p, mesh_j))(
        to_jax(params_np))
    spies = {name: _Spy(monkeypatch, pbe, name) for name in
             ("banded_fwd_plain", "banded_vg_plain", "banded_bwd_plain")}
    te = pt.PlaneStressEnergy(model=pt.TriangleP1())
    p = to_torch(params_np, requires_grad=True)
    vt = te.domain_energy(p, mesh_t)
    gc, gu = torch.autograd.grad(vt, [p["coords"], p["u"]])
    single = change is None
    assert {n: s.calls for n, s in spies.items()} == {
        "banded_fwd_plain": 0 if single else 1,
        "banded_vg_plain": 1 if single else 0,
        "banded_bwd_plain": 0 if single else 1}
    assert_close(float(vt.detach()), float(vj), rtol=1e-5, what="energy")
    for name, got in (("coords", gc), ("u", gu)):
        want = np.asarray(gj[name])
        assert_close(got.numpy(), want, rtol=1e-5,
                     atol=1e-5 * np.abs(want).max(), what=name)
    with torch.no_grad():
        v3 = te.domain_energy(to_torch(params_np), mesh_t)
    assert_close(float(v3), float(vj), rtol=1e-5, what="no_grad energy")


@pytest.mark.parametrize("k", [3, 4, 6])
def test_banded_energy_f64_matches_jax_xla(meshes, k):
    """float64: the port's K3/K4/K5 walk (``banded_element_energy``) and
    its plain banded gather route against the JAX package's XLA route
    under ``jax.enable_x64``.  The JAX package's banded gather does not
    run under x64 (its int32 window starts meet int64 slice indices in
    ``dynamic_slice``: ROADMAP Queue C), so the JAX side is its XLA
    gather route over the same elements."""
    m = meshes["delaunay"]
    arrays = [np.asarray(a) for a in m.astuple()]
    params_np = random_params(m, seed=4)
    with jax.enable_x64(True):
        mj = ht.TriMesh.from_arrays(*arrays, dtype=jnp.float64,
                                    build_lattice=False, build_banded=False)
        je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jnp.float64))
        vj, gj = jax.value_and_grad(lambda p: je.domain_energy(p, mj))(
            to_jax(params_np, dtype=jnp.float64))
        vj, gj = float(vj), {n: np.asarray(g) for n, g in gj.items()}
    _, mt = _mesh_pair(m, k, dtype=torch.float64)
    model = pt.TriangleP1(dtype=torch.float64)
    ba = mt.banded_paired if k != 3 else mt.banded
    routes = {
        "plain gather": lambda p: pt.PlaneStressEnergy(
            model=model).domain_energy(p, mt),
        "K3/K4/K5 walk": lambda p: pbe.banded_element_energy(
            model.packed_nodes(p, mt), ba, 10e9, 0.3, 0.5),
    }
    for name, fn in routes.items():
        p = to_torch(params_np, dtype=torch.float64, requires_grad=True)
        vt = fn(p)
        gt = dict(zip(("coords", "u"), torch.autograd.grad(
            vt, [p["coords"], p["u"]])))
        assert_close(float(vt.detach()), vj, rtol=1e-10, what=name)
        for g in ("coords", "u"):
            assert_close(gt[g].numpy(), gj[g], rtol=1e-8,
                         atol=1e-11 * np.abs(gj[g]).max(), what=name + g)


def test_fused_edges_keep_the_banded_route(monkeypatch, meshes):
    """``fuse_edges=True`` on a banded mesh: both packages skip the fused
    edge total and take the banded route; energies and gradients equal."""
    mesh_j, mesh_t = _mesh_pair(meshes["delaunay"], 4)
    assert mesh_t.fused_connectivity is not None
    params_np = random_params(mesh_j, seed=5)
    jspy = _Spy(monkeypatch, jbe, "banded_element_energy")
    tspy = _Spy(monkeypatch, pbe, "banded_element_energy")
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(),
                              backend="pallas_interpret", fuse_edges=True)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(), fuse_edges=True)
    vj, gj = jax.value_and_grad(lambda p: je.total(p, mesh_j))(
        to_jax(params_np))
    p = to_torch(params_np, requires_grad=True)
    vt = te.total(p, mesh_t)
    gu = torch.autograd.grad(vt, [p["u"]])[0]
    assert jspy.calls >= 1 and tspy.calls == 1
    assert te._fused_total(p, mesh_t) is None
    assert te._fused_total(p, dataclasses.replace(mesh_t, banded=None)) \
        is None                                    # paired tables alone
    assert_close(float(vt.detach()), float(vj), rtol=1e-5)
    want = np.asarray(gj["u"])
    assert_close(gu.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


def test_gather_banded_equal_jax(meshes):
    mesh_j, mesh_t = _mesh_pair(meshes["delaunay"], 3)
    rng = np.random.default_rng(6)
    node = rng.standard_normal((mesh_j.n_nodes, 4)).astype(np.float32)
    gj, vjp = jax.vjp(lambda x: jasm.gather_banded(x, mesh_j.banded),
                      jnp.asarray(node))
    ct = rng.standard_normal(gj.shape).astype(np.float32)
    x = torch.tensor(node, requires_grad=True)
    gt = pasm.gather_banded(x, mesh_t.banded)
    (bt,) = torch.autograd.grad(gt, x, torch.tensor(ct))
    np.testing.assert_array_equal(gt.detach().numpy(), np.asarray(gj))
    want = np.asarray(vjp(jnp.asarray(ct))[0])
    assert_close(bt.numpy(), want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("backend", ["auto", "plain"])
def test_body_force_on_banded_mesh_matches_jax(meshes, backend):
    """A body force leaves the banded kernels in both packages: the plain
    banded gather (``gather_banded``) against the JAX package's."""
    mesh_j, mesh_t = _mesh_pair(meshes["delaunay"], 4)
    params_np = random_params(mesh_j, seed=7)

    def force(pkg):
        return lambda x: pkg.stack([1e6 * x[:, 1], -2e6 * x[:, 0]], 1)

    je = ht.PlaneStressEnergy(model=ht.TriangleP1(), backend="xla",
                              body_force=force(jnp))
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend=backend,
                              body_force=force(torch))
    vj, gj = jax.value_and_grad(lambda p: je.total(p, mesh_j))(
        to_jax(params_np))
    p = to_torch(params_np, requires_grad=True)
    vt = te.total(p, mesh_t)
    gc, gu = torch.autograd.grad(vt, [p["coords"], p["u"]])
    assert_close(float(vt.detach()), float(vj), rtol=1e-5)
    for name, got in (("coords", gc), ("u", gu)):
        want = np.asarray(gj[name])
        assert_close(got.numpy(), want, rtol=1e-5,
                     atol=1e-5 * np.abs(want).max(), what=name)


def _slot_decode(ba, two_pass, n):
    """What the gradient kernels (K4, K5: ``node_gradient`` in
    ``csrc/banded_energy.cu``) decode from each slot d of node n < N, in
    numpy: (valid [N, D], element [N, D], table row [N, D], vertex [N, D],
    window block [N, D], the window tables (starts, rel))."""
    k = ba.k
    if two_pass:
        inc, starts, rel = ba.inc_rel, ba.starts, ba.conn_rel
        sentinel = ba.wct
    else:
        inc, starts, rel = ba.re_inc_rel, ba.re_nstarts, ba.re_conn_rel
        sentinel = k * ba.re_ew
    inc, starts, rel = inc.numpy(), starts.numpy(), rel.numpy()
    slots = inc.reshape(-1, inc.shape[2])[:n].astype(np.int64)
    b = (np.arange(n) // inc.shape[1])[:, None]     # rows placed at 0
    valid = slots != sentinel
    if two_pass:
        c = ba.ct_starts.numpy()[b].astype(np.int64) + slots
        row, vertex = c // k, c % k
        blk = row // rel.shape[1]
        element = row                  # padding rows lie past every element
    else:
        row, vertex = b * rel.shape[1] + slots // k, slots % k
        blk = np.broadcast_to(b, slots.shape)
        element = ba.re_estarts.numpy()[b].astype(np.int64) + slots // k
    zero = np.zeros_like(slots)
    return (valid, np.where(valid, element, -1), np.where(valid, row, zero),
            np.where(valid, vertex, zero), np.where(valid, blk, zero),
            (starts, rel))


DECODE = [(w, k) for w in ("plate", "delaunay") for k in (3, 4, 6)]


@pytest.mark.parametrize("which, k", DECODE)
def test_slot_decode_names_the_node(meshes, which, k):
    """On both kinds of window (window_limit 300: several blocks, and a
    node count that is no multiple of the node block), every valid slot
    of node n decodes to a table row whose vertex is n itself."""
    ba = _tables(pb, meshes[which], k)
    n = meshes[which].n_nodes
    for two_pass in (False, True):
        nb = (ba.inc_rel if two_pass else ba.re_inc_rel).shape[1]
        assert n % nb and n > nb
        valid, _, row, vertex, blk, (starts, rel) = _slot_decode(
            ba, two_pass, n)
        assert valid.any(axis=1).all()         # every node has an element
        named = starts[blk] + rel.reshape(-1)[row * k + vertex]
        owner = np.broadcast_to(np.arange(n)[:, None], valid.shape)
        np.testing.assert_array_equal(named[valid], owner[valid])


@pytest.mark.parametrize("which, k", DECODE)
def test_slot_decodes_agree_across_kinds(meshes, which, k):
    """The recompute and the two-pass decodes name the same elements and
    vertices, slot by slot: the terms K5 adds, and their order, are the
    same on both kinds, which is what makes them bit-equal on the card."""
    ba = _tables(pb, meshes[which], k)
    n = meshes[which].n_nodes
    re = _slot_decode(ba, False, n)
    two = _slot_decode(ba, True, n)
    np.testing.assert_array_equal(re[0], two[0])           # valid slots
    np.testing.assert_array_equal(re[1], two[1])           # elements
    np.testing.assert_array_equal(re[3], two[3])           # vertices
    assert (two[1][two[0]] < meshes[which].n_elements).all()


@pytest.mark.parametrize("which, k", DECODE)
def test_decoded_gradient_matches_plain_bwd(meshes, which, k):
    """float64: the gradient built in plain torch by the kernels' decode
    (the slots' ``_row_cotangents`` terms, summed in slot order, then
    times ct) equals ``banded_bwd_plain`` (held to JAX's
    ``banded_element_energy`` above) on both kinds of window."""
    ba = _tables(pb, meshes[which], k)
    n = meshes[which].n_nodes
    rng = np.random.default_rng(9)
    coords = np.asarray(meshes[which].coords, np.float64)
    node = torch.tensor(np.concatenate(
        [coords + 1e-3 * rng.standard_normal((n, 2)),
         1e-4 * rng.standard_normal((n, 2))], 1))
    ct = torch.tensor(-0.75, dtype=torch.float64)
    args = (10e9, 0.3, 0.5)
    for two_pass in (False, True):
        valid, _, row, vertex, _, (starts, rel) = _slot_decode(
            ba, two_pass, n)
        cot = pbe._row_cotangents(pbe._rows(node, torch.tensor(starts),
                                            torch.tensor(rel)), *args)
        terms = cot[torch.tensor(row), torch.tensor(vertex)]  # [N, D, 4]
        terms[torch.tensor(~valid)] = 0.0
        grad = torch.zeros_like(node)
        for d in range(terms.shape[1]):                       # slot order
            grad = grad + terms[:, d]
        kind = dataclasses.replace(ba, **NO_RECOMPUTE) if two_pass else ba
        want = pbe.banded_bwd_plain(node, kind, ct, *args)
        assert_close((grad * ct).numpy(), want.numpy(), rtol=1e-12,
                     atol=1e-12 * float(want.abs().max()),
                     what=f"two_pass={two_pass}")


def test_banded_kernels_raise_on_cpu_tensors(meshes):
    _, mesh_t = _mesh_pair(meshes["plate"], 4)
    node = torch.zeros((mesh_t.n_nodes, 4))
    ba = mesh_t.banded_paired
    ct = torch.ones(())
    for call in (lambda: pbe.banded_fwd(node, ba, 1.0, 0.3, 0.5),
                 lambda: pbe.banded_vg(node, ba, 1.0, 0.3, 0.5),
                 lambda: pbe.banded_bwd(node, ba, ct, 1.0, 0.3, 0.5)):
        with pytest.raises(ValueError):
            call()
    kernel = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="kernel")
    p = pt.TriangleP1().init(torch.Generator().manual_seed(0), mesh_t,
                             device=CPU)
    with pytest.raises(ValueError):
        kernel.total(p, mesh_t)


@pytest.mark.parametrize("eb", [64, 128])
def test_window_sq_plain_matches_jax_interpret(eb):
    """K8's plain version and tables against the JAX package's probe
    (``tools/microbench_gather.py``, interpret mode) on the 81x41 plate."""
    from tools import microbench_gather as jmg

    mesh_j = jb.reorder_mesh(ht.generate_mesh(nx=81, ny=41, holes=()),
                             build_banded=False)
    conn = np.asarray(mesh_j.connectivity)
    n = mesh_j.n_nodes
    relT, wblk, wp, npad, s = pwg.build_subblocks(conn, n, eb)
    jrel, jwblk, jwp, jnpad, js = jmg.build_subblocks_pallas(conn, n, eb)
    np.testing.assert_array_equal(relT, np.asarray(jrel))
    np.testing.assert_array_equal(wblk, np.asarray(jwblk))
    assert (wp, npad, s) == (jwp, jnpad, js)
    node = np.random.default_rng(8).standard_normal((n, 4)).astype(
        np.float32)
    node_pad = np.zeros((npad, 4), np.float32)
    node_pad[:n] = node
    want = float(jmg.pallas_masked_sq(jnp.asarray(node_pad), jrel, jwblk,
                                      wp, eb, interpret=True))
    got = pwg.window_sq_plain(pwg.pad_nodes(torch.tensor(node), npad),
                              torch.tensor(relT), torch.tensor(wblk), wp)
    assert_close(float(got), want, rtol=1e-5)
    flat = pwg.flat_sq_plain(torch.tensor(node), torch.tensor(conn))
    assert_close(float(flat), want, rtol=1e-5)
    with pytest.raises(ValueError):
        pwg.window_sq(torch.tensor(node_pad), torch.tensor(relT),
                      torch.tensor(wblk), wp)
