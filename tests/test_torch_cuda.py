"""The port's CUDA kernels on the card against their plain torch versions.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  This file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: rtol 1e-4 on energies (f32 sums in another order); rtol 5e-4
with atol 1e-5 x max|grad| on cotangents and gradients (coordinate
gradients are sums of cancelling terms; see tests/test_torch_losses.py).
Where two kernels must add the same terms in the same order (K5 and the
fused K4, K5 over its two kinds of window, K6 and K7, two launches of one
kernel) the check is bit for bit.  The drivers' captured step (one CUDA
graph a step, replayed) is held bit for bit to the same steps run
eagerly on the card, on every route where two eager runs are bit-equal.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.models.structured_grid import (
    StructuredGridP1, generate_structured_grid)
from hidenn_fem_tpu_torch.mesh import banded as mb
from hidenn_fem_tpu_torch.ops import banded_energy as be
from hidenn_fem_tpu_torch.ops import element_energy as ee
from hidenn_fem_tpu_torch.ops import lattice_slab as ls
from hidenn_fem_tpu_torch.ops import window_gather as wg

pytestmark = pytest.mark.cuda

E, NU, W_SUM = 10e9, 0.3, 0.5


@pytest.fixture
def dev():
    """The card; skips where there is none (decided at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (runs on the card)")
    return torch.device("cuda", 0)


def _close(got, want, rtol=5e-4, atol_scale=1e-5):
    got = got.detach().double().cpu().numpy()
    want = want.detach().double().cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_scale * np.abs(want).max())


def _columns(ne, seed):
    """Mesh-like corners (cx, cy, ux, uy) of ne triangles, some clockwise,
    followed by a zero, an all-equal and a collinear column."""
    rng = np.random.default_rng(seed)
    h = 0.05
    base = np.asarray([[0.0, 0.0], [h, 0.0], [0.0, h]])
    xy = (base[None] + 0.1 * h * rng.standard_normal((ne, 3, 2))
          + rng.uniform(0.0, 1.0, (ne, 1, 2)))
    flip = rng.random(ne) < 0.5
    xy[flip] = xy[flip][:, [1, 0, 2]]
    g = np.concatenate([xy, 1e-4 * rng.standard_normal((ne, 3, 2))], -1)
    special = np.asarray([
        [[0.0] * 4] * 3,
        [[0.25, 0.5, 1e-4, -1e-4]] * 3,
        [[0.5, 0.5, 1e-4, 0.0], [0.25, 0.25, 0.0, 1e-4], [0.0] * 4]])
    return np.concatenate([g, special]).astype(np.float32)


@pytest.mark.parametrize("with_edges", [False, True])
def test_kernels_match_plain(dev, with_edges):
    g = _columns(5001, 1)
    n = g.shape[0] * 3
    node = torch.tensor(g.reshape(n, 4), device=dev)
    conn = torch.arange(n, dtype=torch.int32, device=dev).reshape(-1, 3)
    edge_start, tw = (4000, -1e5) if with_edges else (None, 0.0)
    ct = torch.tensor(-1.5, device=dev)
    gt = torch.tensor(g, device=dev)
    before = dict(ee.launch_counts)
    v_k = ee.element_energy_fwd(node, conn, E, NU, W_SUM, edge_start, tw)
    c_k = ee.element_energy_bwd(node, conn, ct, E, NU, W_SUM, edge_start,
                                tw)
    torch.cuda.synchronize()
    assert ee.launch_counts["element_energy_fwd"] == \
        before["element_energy_fwd"] + 1
    assert ee.launch_counts["element_energy_bwd"] == \
        before["element_energy_bwd"] + 1
    v_p = ee.element_energy_plain(gt, E, NU, W_SUM, edge_start, tw)
    c_p = ee.element_cotangent_plain(gt, ct, E, NU, W_SUM, edge_start, tw)
    _close(v_k, v_p, rtol=1e-4, atol_scale=0.0)
    _close(c_k, c_p)
    # exact zeros of the zero and all-equal columns (none past edge_start)
    if not with_edges:
        assert torch.all(c_k[-3:-1] == 0)


def test_incidence_sum_matches_plain(dev):
    """The node-gradient kernel against the plain incidence gather-sum on
    a mesh with dead nodes (all -1 incidence rows: exactly zero)."""
    from hidenn_fem_tpu_torch.ops.assembly import assemble_node_grad
    mesh = pt.generate_mesh(nx=61, ny=31, keep_dead_nodes=True, device=dev)
    rng = np.random.default_rng(3)
    cot = torch.tensor(rng.standard_normal((mesh.n_elements, 3, 4)),
                       dtype=torch.float32, device=dev)
    before = ee.launch_counts["incidence_sum"]
    got = ee.incidence_sum(cot, mesh.incidence)
    want = assemble_node_grad(cot, mesh.connectivity, mesh.incidence,
                              mesh.n_nodes)
    torch.cuda.synchronize()
    assert ee.launch_counts["incidence_sum"] == before + 1
    _close(got, want, rtol=1e-6, atol_scale=1e-6)
    dead = (mesh.incidence < 0).all(dim=1)
    assert dead.any() and torch.all(got[dead] == 0)


def test_kernel_refuses_what_it_does_not_take(dev):
    node = torch.zeros((6, 4), device=dev)
    conn = torch.arange(6, dtype=torch.int32, device=dev).reshape(2, 3)
    with pytest.raises(ValueError):
        ee.element_energy_fwd(node.double(), conn, E, NU, W_SUM)
    with pytest.raises(ValueError):
        ee.element_energy_fwd(node, conn.long(), E, NU, W_SUM)
    with pytest.raises(ValueError):
        ee.element_energy_fwd(node[:, :3].contiguous(), conn, E, NU, W_SUM)
    with pytest.raises(ValueError):
        ee.incidence_sum(node.reshape(2, 3, 4), conn.long())


@pytest.mark.parametrize("fuse_edges", [False, True])
def test_energy_kernel_path_matches_plain_path(dev, fuse_edges):
    """The gather route (lattice stripped): K1, K2 and incidence_sum."""
    mesh = dataclasses.replace(
        pt.generate_mesh(nx=41, ny=21, keep_dead_nodes=True, device=dev),
        lattice=None)
    rng = np.random.default_rng(2)
    n = mesh.n_nodes
    params_np = {"coords": mesh.coords.cpu().numpy()
                 + 1e-3 * rng.standard_normal((n, 2)),
                 "u": 1e-4 * rng.standard_normal((n, 2))}
    out = {}
    for backend in ("kernel", "plain"):
        p = pt.params_from_numpy(params_np, device=dev)
        for v in p.values():
            v.requires_grad_(True)
        e = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend=backend,
                                 fuse_edges=fuse_edges)
        val = e.total(p, mesh)
        out[backend] = (val,) + torch.autograd.grad(
            val, [p["coords"], p["u"]])
    _close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol_scale=0.0)
    for a, b in zip(out["kernel"][1:], out["plain"][1:]):
        _close(a, b)


def _lattice_node(nx, ny, seed, dev):
    rng = np.random.default_rng(seed)
    xs, ys = np.meshgrid(np.linspace(0, 2, nx), np.linspace(0, 1, ny),
                         indexing="ij")
    xy = np.stack([xs, ys], -1).reshape(-1, 2)
    node = np.concatenate([xy + 1e-3 * rng.standard_normal(xy.shape),
                           1e-4 * rng.standard_normal(xy.shape)], 1)
    return torch.tensor(node, dtype=torch.float32, device=dev), rng


@pytest.mark.parametrize("shape", [(300, 37), (2, 2), (37, 53), (129, 65)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("diag", [ls.UP, ls.DOWN, ls.SEL_MASK, ls.PARITY])
@pytest.mark.parametrize("masked", [False, True])
def test_lattice_stencil_kernels_match_plain(dev, shape, diag, masked):
    """K7 and K6 against their plain versions for every diagonal mode,
    with and without presence weights, on lattices that are no multiple of
    the tile (down to a single quad); K6's energy equal to K7's bit for
    bit, and two launches of each bit-equal."""
    nx, ny = shape
    node, rng = _lattice_node(nx, ny, 7, dev)
    q = (nx - 1, ny - 1)
    kw = dict(diag=diag, phase=1 if diag == ls.PARITY else 0)
    if diag == ls.SEL_MASK:
        kw["sel"] = torch.tensor((rng.random(q) > 0.5).astype(np.float32),
                                 device=dev)
    if masked:
        for k in ("t1", "t2"):
            kw[k] = torch.tensor((rng.random(q) > 0.1).astype(np.float32),
                                 device=dev)
    before = dict(ls.launch_counts)
    e7 = ls.lattice_stencil_fwd(node, nx, ny, E, NU, W_SUM, **kw)
    e6, g6 = ls.lattice_stencil_vg(node, nx, ny, E, NU, W_SUM, **kw)
    e7b = ls.lattice_stencil_fwd(node, nx, ny, E, NU, W_SUM, **kw)
    e6b, g6b = ls.lattice_stencil_vg(node, nx, ny, E, NU, W_SUM, **kw)
    torch.cuda.synchronize()
    assert ls.launch_counts["lattice_stencil_fwd"] == \
        before["lattice_stencil_fwd"] + 2
    assert ls.launch_counts["lattice_stencil_vg"] == \
        before["lattice_stencil_vg"] + 2
    ep, gp = ls.lattice_stencil_vg_plain(node, nx, ny, E, NU, W_SUM, **kw)
    assert float(e6) == float(e7)      # same tiles, same threads
    assert float(e7b) == float(e7) and float(e6b) == float(e6)
    assert torch.equal(g6b, g6)
    _close(e7, ep, rtol=1e-4, atol_scale=0.0)
    _close(g6, gp)


def test_lattice_route_kernel_path_matches_plain_path(dev):
    """PlaneStressEnergy on the keep-dead zigzag plate (sel, t1, t2 in use):
    the stencil kernels against the plain lattice route, value and both
    gradient groups; K7 under no_grad gives K6's energy."""
    mesh = pt.generate_mesh(nx=61, ny=31, keep_dead_nodes=True, device=dev)
    assert mesh.lattice.identity and mesh.lattice.uniform_sel == ""
    rng = np.random.default_rng(2)
    n = mesh.n_nodes
    params_np = {"coords": mesh.coords.cpu().numpy()
                 + 1e-3 * rng.standard_normal((n, 2)),
                 "u": 1e-4 * rng.standard_normal((n, 2))}
    out = {}
    for backend in ("kernel", "plain"):
        p = pt.params_from_numpy(params_np, device=dev)
        for v in p.values():
            v.requires_grad_(True)
        e = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend=backend)
        before = dict(ls.launch_counts)
        val = e.total(p, mesh)
        out[backend] = (val,) + torch.autograd.grad(
            val, [p["coords"], p["u"]])
        grew = ls.launch_counts["lattice_stencil_vg"] - \
            before["lattice_stencil_vg"]
        assert grew == (1 if backend == "kernel" else 0)
    _close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol_scale=0.0)
    for a, b in zip(out["kernel"][1:], out["plain"][1:]):
        _close(a, b)
    with torch.no_grad():
        p = pt.params_from_numpy(params_np, device=dev)
        e = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="kernel")
        before = ls.launch_counts["lattice_stencil_fwd"]
        v7 = e.total(p, mesh)
        assert ls.launch_counts["lattice_stencil_fwd"] == before + 1
    assert float(v7) == float(out["kernel"][0].detach())


@pytest.mark.parametrize("split", ["up", "zigzag"])
def test_structured_kernel_path_matches_plain_path(dev, split):
    grid = generate_structured_grid(nx=97, ny=49, split=split,
                                    holes=((1.0, 0.5, 0.3),), device=dev)
    out = {}
    for backend in ("kernel", "plain"):
        model = StructuredGridP1(backend=backend)
        p = model.init(np.random.default_rng(4), grid, device=dev)
        p["u"] = p["u"] * 10.0
        for v in p.values():
            v.requires_grad_(True)
        val = model.total(p, grid)
        out[backend] = (val,) + torch.autograd.grad(
            val, [p["coords"], p["u"]])
    _close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol_scale=0.0)
    for a, b in zip(out["kernel"][1:], out["plain"][1:]):
        _close(a, b)


def test_lattice_kernels_refuse_what_they_do_not_take(dev):
    node = torch.zeros((12, 4), device=dev)
    with pytest.raises(ValueError):
        ls.lattice_stencil_fwd(node.double(), 4, 3, E, NU, W_SUM)
    with pytest.raises(ValueError):
        ls.lattice_stencil_fwd(node, 3, 3, E, NU, W_SUM)
    with pytest.raises(ValueError):
        ls.lattice_stencil_fwd(node, 4, 3, E, NU, W_SUM, diag=ls.SEL_MASK)
    renumbered = pt.generate_mesh(nx=33, ny=17, device=dev)
    assert not renumbered.lattice.identity
    kernel = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="kernel")
    p = pt.TriangleP1().init(torch.Generator().manual_seed(0), renumbered,
                             device=dev)
    with pytest.raises(ValueError):
        kernel.total(p, renumbered)


def _banded_tables(mesh, k, device):
    """Banded tables of one layout at window_limit 300 (several blocks)."""
    conn = mesh.connectivity.cpu().numpy()
    n = mesh.n_nodes
    if k == 3:
        return mb.build_banded_assembly(conn, n, mesh.incidence.cpu().numpy(),
                                        window_limit=300, device=device)
    build = mb.build_paired_assembly if k == 4 else mb.build_striped_assembly
    return build(conn, n, window_limit=300, device=device)


def _banded_node(mesh, dev, seed=5):
    rng = np.random.default_rng(seed)
    n = mesh.n_nodes
    node = np.concatenate([mesh.coords.cpu().numpy()
                           + 1e-3 * rng.standard_normal((n, 2)),
                           1e-4 * rng.standard_normal((n, 2))], 1)
    return torch.tensor(node, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("k", [3, 4, 6])
@pytest.mark.parametrize("which", ["plate", "delaunay"])
def test_banded_kernels_match_plain(dev, k, which):
    """K3, K4 and K5 (both fallbacks) against their plain versions; the
    fused K4's gradient equal to K5's over the recompute windows (ct x K4)
    bit for bit, and two launches of K4 bit-equal."""
    mesh = (pt.proxy_plate_mesh(nx=33, ny=17, device=dev) if which == "plate"
            else pt.generate_mesh_delaunay(lc=0.09, device=dev))
    ba = _banded_tables(mesh, k, dev)
    assert ba is not None and ba.re_own_lo is not None
    assert ba.n_element_blocks > 1
    node = _banded_node(mesh, dev)
    ct = torch.tensor(0.75, device=dev)
    before = dict(be.launch_counts)
    e3 = be.banded_fwd(node, ba, E, NU, W_SUM)
    e4, g4 = be.banded_vg(node, ba, E, NU, W_SUM)
    e4b, g4b = be.banded_vg(node, ba, E, NU, W_SUM)
    g5 = be.banded_bwd(node, ba, ct, E, NU, W_SUM)
    no_re = dataclasses.replace(ba, re_nstarts=None, re_estarts=None,
                                re_conn_rel=None, re_inc_rel=None,
                                re_own_lo=None, re_own_hi=None)
    g5b = be.banded_bwd(node, no_re, ct, E, NU, W_SUM)
    torch.cuda.synchronize()
    assert {k2: be.launch_counts[k2] - before[k2] for k2 in before} == \
        {"banded_fwd": 1, "banded_vg": 2, "banded_bwd": 2,
         "banded_vg_rows": 0, "banded_bwd_rows": 0}
    p3 = be.banded_fwd_plain(node, ba, E, NU, W_SUM)
    p4, pg4 = be.banded_vg_plain(node, ba, E, NU, W_SUM)
    _close(e3, p3, rtol=1e-4, atol_scale=0.0)
    _close(e4, p4, rtol=1e-4, atol_scale=0.0)
    _close(e4, e3, rtol=1e-4, atol_scale=0.0)
    _close(g4, pg4)
    _close(g5, be.banded_bwd_plain(node, ba, ct, E, NU, W_SUM))
    _close(g5b, be.banded_bwd_plain(node, no_re, ct, E, NU, W_SUM))
    assert torch.equal(g5, ct * g4)
    assert torch.equal(g5b, g5)
    assert float(e4b) == float(e4) and torch.equal(g4b, g4)


@pytest.mark.parametrize("ct_value", [1.0, 0.75, -2.0])
@pytest.mark.parametrize("k", [3, 4, 6])
def test_banded_bwd_is_one_launch_on_both_kinds(dev, k, ct_value):
    """K5 over the recompute windows and over the two-pass windows: one
    launch of one kernel per call (the launch count and the profiler
    agree), each against ``banded_bwd_plain``; over the recompute windows
    equal to ct x K4 bit for bit, over the two-pass windows equal to the
    recompute windows bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    mesh = pt.generate_mesh_delaunay(lc=0.09, device=dev)
    ba = _banded_tables(mesh, k, dev)
    assert ba.re_conn_rel is not None and ba.n_element_blocks > 1
    two_pass = dataclasses.replace(ba, re_nstarts=None, re_estarts=None,
                                   re_conn_rel=None, re_inc_rel=None,
                                   re_own_lo=None, re_own_hi=None)
    node = _banded_node(mesh, dev)
    ct = torch.tensor(ct_value, device=dev)
    _, g4 = be.banded_vg(node, ba, E, NU, W_SUM)
    torch.cuda.synchronize()
    out = {}
    calls = 3
    for name, tables in (("recompute", ba), ("two-pass", two_pass)):
        before = be.launch_counts["banded_bwd"]
        g = be.banded_bwd(node, tables, ct, E, NU, W_SUM)
        torch.cuda.synchronize()
        assert be.launch_counts["banded_bwd"] == before + 1, name
        for _ in range(3):       # the profiler can drop kernel events
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    be.banded_bwd(node, tables, ct, E, NU, W_SUM)
                torch.cuda.synchronize()
            kernels = [(("banded_grad_kernel" in e.key), e.count)
                       for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CUDA]
            if sum(c for _, c in kernels) == calls:
                break
        assert kernels == [(True, calls)], name
        _close(g, be.banded_bwd_plain(node, tables, ct, E, NU, W_SUM))
        out[name] = g
    assert torch.equal(out["recompute"], ct * g4)
    assert torch.equal(out["two-pass"], out["recompute"])


def test_banded_route_kernel_path_matches_plain_path(dev):
    """PlaneStressEnergy on a banded Delaunay mesh: the banded kernels
    (K4 with a gradient, K3 under no_grad) against the plain route."""
    mesh = pt.generate_mesh_delaunay(lc=0.09, device=dev)
    mesh = dataclasses.replace(mesh, banded=_banded_tables(mesh, 3, dev),
                               banded_paired=_banded_tables(mesh, 4, dev))
    params_np = {"coords": mesh.coords.cpu().numpy(),
                 "u": 1e-4 * np.random.default_rng(6).standard_normal(
                     (mesh.n_nodes, 2))}
    out = {}
    for backend in ("kernel", "plain"):
        p = pt.params_from_numpy(params_np, device=dev)
        for v in p.values():
            v.requires_grad_(True)
        e = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend=backend)
        before = be.launch_counts["banded_vg"]
        val = e.total(p, mesh)
        out[backend] = (val,) + torch.autograd.grad(
            val, [p["coords"], p["u"]])
        assert be.launch_counts["banded_vg"] - before == \
            (1 if backend == "kernel" else 0)
    _close(out["kernel"][0], out["plain"][0], rtol=1e-4, atol_scale=0.0)
    for a, b in zip(out["kernel"][1:], out["plain"][1:]):
        _close(a, b)
    with torch.no_grad():
        p = pt.params_from_numpy(params_np, device=dev)
        e = pt.PlaneStressEnergy(model=pt.TriangleP1(), backend="kernel")
        before = dict(be.launch_counts)
        v3 = e.total(p, mesh)
        assert be.launch_counts["banded_fwd"] == before["banded_fwd"] + 1
        assert be.launch_counts["banded_vg"] == before["banded_vg"]
    _close(v3, out["kernel"][0], rtol=1e-5, atol_scale=0.0)


@pytest.mark.parametrize("eb", [64, 128])
def test_window_sq_matches_plain(dev, eb):
    """K8 against its plain version and the flat-gather sum."""
    mesh = mb.reorder_mesh(pt.generate_mesh(nx=81, ny=41, holes=(),
                                            device=dev), build_banded=False)
    conn = mesh.connectivity.cpu().numpy()
    relT, wblk, wp, npad, _ = wg.build_subblocks(conn, mesh.n_nodes, eb)
    node = torch.tensor(np.random.default_rng(8).standard_normal(
        (mesh.n_nodes, 4)), dtype=torch.float32, device=dev)
    node_pad = wg.pad_nodes(node, npad)
    relT_d = torch.tensor(relT, device=dev)
    wblk_d = torch.tensor(wblk, device=dev)
    before = wg.launch_counts["window_sq"]
    got = wg.window_sq(node_pad, relT_d, wblk_d, wp)
    torch.cuda.synchronize()
    assert wg.launch_counts["window_sq"] == before + 1
    _close(got, wg.window_sq_plain(node_pad, relT_d, wblk_d, wp), rtol=1e-5,
           atol_scale=0.0)
    _close(got, wg.flat_sq_plain(node, torch.tensor(conn, device=dev)),
           rtol=1e-5, atol_scale=0.0)


def test_banded_kernels_refuse_what_they_do_not_take(dev):
    mesh = pt.proxy_plate_mesh(nx=33, ny=17, device=dev)
    ba = _banded_tables(mesh, 4, torch.device("cpu"))
    node = _banded_node(mesh, dev)
    with pytest.raises(ValueError):        # tables left on the host
        be.banded_fwd(node, ba, E, NU, W_SUM)
    ba = ba.to(dev)
    with pytest.raises(ValueError):
        be.banded_fwd(node.double(), ba, E, NU, W_SUM)
    with pytest.raises(ValueError):
        be.banded_vg(node, dataclasses.replace(ba, re_own_lo=None), E, NU,
                     W_SUM)
    with pytest.raises(ValueError):
        be.banded_fwd(node.cpu(), ba, E, NU, W_SUM)



# ------------------------------------------------ row windows, row_start
def _windows(nx, n):
    """``n`` windows of ceil(nx / n) node rows (the ranks' split of
    ``parallel/sharded_slab.py``); empty ones dropped."""
    from hidenn_fem_tpu_torch.parallel.sharded_slab import row_window
    return [w for w in (row_window(nx, r, n) for r in range(n))
            if w[0] < w[1]]


@pytest.mark.parametrize("shape", [(300, 37), (2, 2), (37, 53), (129, 65)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("diag", [ls.UP, ls.SEL_MASK, ls.PARITY])
@pytest.mark.parametrize("masked", [False, True])
def test_lattice_row_windows_match_whole_lattice(dev, shape, diag, masked):
    """K6 and K7 over 2, 3 and 4 row windows: each window's gradient rows
    equal the whole-lattice K6's bit for bit and its other rows are 0; K6's
    window energy equals K7's bit for bit; the windows against their plain
    versions; the window energies sum to the whole lattice's."""
    nx, ny = shape
    node, rng = _lattice_node(nx, ny, 11, dev)
    q = (nx - 1, ny - 1)
    kw = dict(diag=diag, phase=1 if diag == ls.PARITY else 0)
    if diag == ls.SEL_MASK:
        kw["sel"] = torch.tensor((rng.random(q) > 0.5).astype(np.float32),
                                 device=dev)
    if masked:
        for k in ("t1", "t2"):
            kw[k] = torch.tensor((rng.random(q) > 0.1).astype(np.float32),
                                 device=dev)
    e_whole, g_whole = ls.lattice_stencil_vg(node, nx, ny, E, NU, W_SUM, **kw)
    for n in (2, 3, 4):
        total = 0.0
        for lo, hi in _windows(nx, n):
            before = dict(ls.launch_counts)
            e6, g6 = ls.lattice_stencil_vg_rows(node, nx, ny, E, NU, W_SUM,
                                                lo, hi, **kw)
            e7 = ls.lattice_stencil_fwd_rows(node, nx, ny, E, NU, W_SUM, lo,
                                             hi, **kw)
            torch.cuda.synchronize()
            assert ls.launch_counts["lattice_stencil_vg_rows"] == \
                before["lattice_stencil_vg_rows"] + 1
            assert ls.launch_counts["lattice_stencil_fwd_rows"] == \
                before["lattice_stencil_fwd_rows"] + 1
            rows = slice(lo * ny, hi * ny)
            assert torch.equal(g6[rows], g_whole[rows])
            assert not g6[:lo * ny].any() and not g6[hi * ny:].any()
            assert float(e6) == float(e7)
            pe, pg = ls.lattice_stencil_vg_rows_plain(node, nx, ny, E, NU,
                                                      W_SUM, lo, hi, **kw)
            _close(e6, pe, rtol=1e-4, atol_scale=0.0)
            _close(g6, pg)
            total += float(e6)
        np.testing.assert_allclose(total, float(e_whole), rtol=1e-5)


@pytest.mark.parametrize("k", [3, 4, 6])
def test_banded_row_start_matches_unsharded(dev, k):
    """K4 and K5 on each rank's slice of tables rebanded for 4 ranks: the
    rows placed at row_start equal the unsharded K4/K5 rows on the same
    tables bit for bit, every other row 0; the slices' energies sum to the
    whole; each slice against its plain version."""
    from hidenn_fem_tpu_torch.parallel.sharding import rank_tables

    mesh = pt.generate_mesh_delaunay(lc=0.09, device=dev)
    conn = mesh.connectivity.cpu().numpy()
    n = mesh.n_nodes
    kw = dict(window_limit=300, block_multiple=4, device=dev)
    ba = (mb.build_banded_assembly(conn, n, mesh.incidence.cpu().numpy(),
                                   **kw) if k == 3 else
          (mb.build_paired_assembly if k == 4 else
           mb.build_striped_assembly)(conn, n, **kw))
    assert ba.re_own_lo is not None and ba.re_nstarts.shape[0] % 4 == 0
    node = _banded_node(mesh, dev)
    ct = torch.tensor(0.75, device=dev)
    e4, g4 = be.banded_vg(node, ba, E, NU, W_SUM)
    no_own = dataclasses.replace(ba, re_own_lo=None, re_own_hi=None)
    g5 = be.banded_bwd(node, no_own, ct, E, NU, W_SUM)
    total = 0.0
    for rank in range(4):
        loc, rs = rank_tables(ba, rank, 4)
        before = dict(be.launch_counts)
        e, g = be.banded_vg_rows(node, loc, E, NU, W_SUM, rs)
        loc5 = dataclasses.replace(loc, re_own_lo=None, re_own_hi=None)
        g5r = be.banded_bwd_rows(node, loc5, ct, E, NU, W_SUM, rs)
        torch.cuda.synchronize()
        grew = {c: be.launch_counts[c] - before[c] for c in before}
        end = min(n, rs + loc.re_inc_rel.shape[0] * loc.re_inc_rel.shape[1])
        assert grew["banded_vg_rows"] == 1 and grew["banded_bwd_rows"] == 1
        assert torch.equal(g[rs:end], g4[rs:end])
        assert torch.equal(g5r[rs:end], g5[rs:end])
        assert not g[:rs].any() and not g[end:].any()
        assert not g5r[:rs].any() and not g5r[end:].any()
        pe, pg = be.banded_vg_plain(node, loc, E, NU, W_SUM, rs)
        _close(e, pe, rtol=1e-4, atol_scale=0.0)
        _close(g, pg)
        _close(g5r, be.banded_bwd_plain(node, loc5, ct, E, NU, W_SUM, rs))
        total += float(e)
    np.testing.assert_allclose(total, float(e4), rtol=1e-5)


# the redesigned row launches (one launch each: the rows outside the
# window or slice, and the energy sum, written by the kernel itself)
def _is_plus_zero(t):
    """Every entry exactly +0.0 (not -0.0, not NaN)."""
    return bool(((t == 0) & ~torch.signbit(t)).all())


def _stencil_case(nx, ny, dev, masked=True, seed=21):
    """A zigzag lattice (the parity) with about a tenth of the triangles
    absent when ``masked``."""
    node, rng = _lattice_node(nx, ny, seed, dev)
    kw = dict(diag=ls.PARITY, phase=1)
    if masked:
        for k in ("t1", "t2"):
            kw[k] = torch.tensor(
                (rng.random((nx - 1, ny - 1)) > 0.1).astype(np.float32),
                device=dev)
    return node, kw


def _rows_into(grad, node, nx, ny, w_sum, lo, hi, kw):
    """K6 over the node rows [lo, hi) into the given output ``grad``."""
    args = dict(phase=0, sel=None, t1=None, t2=None)
    args.update(kw)
    return ls._launch(True, node, nx, ny, E, NU, w_sum, rows=(lo, hi),
                      grad=grad, **args)


# windows of 1, 4 and 6 node rows at row_lo = 0, inside, and at row_hi =
# nx; (37, 53) is narrower than one tile row (7 x 31 nodes) in both
NARROW_WINDOWS = [(0, 1), (0, 4), (0, 6), (3, 4), (14, 18), (20, 26),
                  (36, 37), (33, 37), (31, 37)]


@pytest.mark.parametrize("shape", [(37, 53), (300, 37)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("masked", [False, True])
def test_narrow_row_windows_match_whole_lattice(dev, shape, masked):
    """K6 over windows of 1, 4 and 6 rows (NARROW_WINDOWS, and the same at
    the end of a 300-row lattice) in a NaN-filled output: the window's rows
    bit-equal to the whole-lattice K6's, every other row +0.0, one launch a
    call, the energy bit-equal to K7's over the window and within rtol
    1e-4 of the plain version."""
    nx, ny = shape
    node, kw = _stencil_case(nx, ny, dev, masked)
    _, g_whole = ls.lattice_stencil_vg(node, nx, ny, E, NU, W_SUM, **kw)
    windows = [(lo + nx - 37, hi + nx - 37) if lo >= 20 else (lo, hi)
               for lo, hi in NARROW_WINDOWS]
    for lo, hi in windows:
        grad = torch.full_like(node, float("nan"))
        before = ls.launch_counts["lattice_stencil_vg_rows"]
        e6, g6 = _rows_into(grad, node, nx, ny, W_SUM, lo, hi, kw)
        assert g6 is grad
        assert ls.launch_counts["lattice_stencil_vg_rows"] == before + 1
        e7 = ls.lattice_stencil_fwd_rows(node, nx, ny, E, NU, W_SUM, lo, hi,
                                         **kw)
        torch.cuda.synchronize()
        rows = slice(lo * ny, hi * ny)
        assert torch.equal(g6[rows], g_whole[rows]), (lo, hi)
        assert _is_plus_zero(g6[:lo * ny]) and _is_plus_zero(g6[hi * ny:])
        assert float(e6) == float(e7)
        pe, pg = ls.lattice_stencil_vg_rows_plain(node, nx, ny, E, NU, W_SUM,
                                                  lo, hi, **kw)
        _close(e6, pe, rtol=1e-4, atol_scale=0.0)
        _close(g6, pg)


@pytest.mark.parametrize("shape,ranks", [((65, 33), 4), ((33, 17), 4),
                                         ((17, 9), 4), ((17, 9), 3)],
                         ids=lambda v: str(v))
def test_padded_level_windows_fill_a_nan_output(dev, shape, ranks):
    """On a multigrid level padded with DEAD rows for ``ranks`` ranks
    (windows of 17, 9, 5 and 6 rows), K6 over each rank's window into a
    NaN-filled output: the window's rows bit-equal to the whole-level
    K6's, every other row +0.0, the energy bit-equal to K7's and within
    rtol 1e-4 of the plain version, the window energies summing to the
    whole."""
    from hidenn_fem_tpu_torch.parallel import sharded_mg as smg
    from hidenn_fem_tpu_torch.parallel.sharded_slab import row_window

    grid, model, params = _mg_plate(*shape, dev)
    coords = model.coords(params, grid).detach()
    gP, cP, uP, k = smg._pad(grid, coords, params["u"], ranks)
    assert k != 0 and gP.nx % ranks == 0
    nx, ny = gP.nx, gP.ny
    node = torch.cat([model.coords({"coords": cP}, gP),
                      model.u_full({"u": uP}, gP)], dim=-1).reshape(-1, 4)
    node = node.detach().contiguous()
    kw = ls.structured_stencil(gP.quad_mask, gP.split, gP.zigzag_phase,
                               torch.float32)
    e_whole, g_whole = ls.lattice_stencil_vg(node, nx, ny, E, NU, 0.5, **kw)
    total = 0.0
    for r in range(ranks):
        lo, hi = row_window(nx, r, ranks)
        grad = torch.full_like(node, float("nan"))
        e6, g6 = _rows_into(grad, node, nx, ny, 0.5, lo, hi, kw)
        e7 = ls.lattice_stencil_fwd_rows(node, nx, ny, E, NU, 0.5, lo, hi,
                                         **kw)
        torch.cuda.synchronize()
        rows = slice(lo * ny, hi * ny)
        assert torch.equal(g6[rows], g_whole[rows])
        assert _is_plus_zero(g6[:lo * ny]) and _is_plus_zero(g6[hi * ny:])
        assert float(e6) == float(e7)
        pe, pg = ls.lattice_stencil_vg_rows_plain(node, nx, ny, E, NU, 0.5,
                                                  lo, hi, **kw)
        _close(e6, pe, rtol=1e-4, atol_scale=0.0)
        _close(g6, pg)
        total += float(e6)
    np.testing.assert_allclose(total, float(e_whole), rtol=1e-5)


def _rank_slices(mesh, k, ranks, window_limit, dev):
    """The mesh's k-slot tables rebanded for ``ranks`` ranks, its node
    table and each rank's (slice, row_start)."""
    from hidenn_fem_tpu_torch.parallel.sharding import rank_tables

    conn = mesh.connectivity.cpu().numpy()
    n = mesh.n_nodes
    kw = dict(window_limit=window_limit, block_multiple=ranks, device=dev)
    ba = (mb.build_banded_assembly(conn, n, mesh.incidence.cpu().numpy(),
                                   **kw) if k == 3 else
          (mb.build_paired_assembly if k == 4 else
           mb.build_striped_assembly)(conn, n, **kw))
    return ba, _banded_node(mesh, dev), [rank_tables(ba, r, ranks)
                                         for r in range(ranks)]


@pytest.mark.parametrize("k", [3, 4, 6])
def test_banded_row_start_fills_a_nan_output(dev, k):
    """K4 on each rank's slice (4 ranks) into a NaN-filled output, one
    launch a call: the placed rows bit-equal to the unsharded K4's, every
    other row +0.0, the energy bit-equal to a launch into a fresh
    output; the whole tables' K4 into a NaN-filled output equals it."""
    ba, node, slices = _rank_slices(
        pt.generate_mesh_delaunay(lc=0.09, device=dev), k, 4, 300, dev)
    n = node.shape[0]
    e4, g4 = be.banded_vg(node, ba, E, NU, W_SUM)
    nan = torch.full_like(node, float("nan"))
    ew, gw = be._vg_launch("banded_vg", node, ba, E, NU, W_SUM, 0, grad=nan)
    assert float(ew) == float(e4) and torch.equal(gw, g4)
    for loc, rs in slices:
        grad = torch.full_like(node, float("nan"))
        before = be.launch_counts["banded_vg_rows"]
        e, g = be._vg_launch("banded_vg_rows", node, loc, E, NU, W_SUM, rs,
                             grad=grad)
        assert g is grad and be.launch_counts["banded_vg_rows"] == before + 1
        ef, _ = be.banded_vg_rows(node, loc, E, NU, W_SUM, rs)
        torch.cuda.synchronize()
        end = min(n, rs + loc.re_inc_rel.shape[0] * loc.re_inc_rel.shape[1])
        assert torch.equal(g[rs:end], g4[rs:end])
        assert _is_plus_zero(g[:rs]) and _is_plus_zero(g[end:])
        assert float(e) == float(ef)


def test_empty_banded_slice_writes_every_row_zero(dev):
    """A slice of table padding only (the 33x17 proxy plate's paired
    tables at window limit 100 for 16 ranks: the last slice places no
    row): K4 at its row_start is still one launch, every row of a
    NaN-filled output comes back +0.0, and its energy equals the plain
    version's."""
    mesh = dataclasses.replace(pt.proxy_plate_mesh(nx=33, ny=17, device=dev),
                               lattice=None)
    ba, node, slices = _rank_slices(mesh, 4, 16, 100, dev)
    n = node.shape[0]
    empty = [(loc, rs) for loc, rs in slices if be._placed_rows(
        loc.re_inc_rel.shape[0] * loc.re_inc_rel.shape[1], rs, n) == 0]
    assert empty
    for loc, rs in empty:
        grad = torch.full_like(node, float("nan"))
        before = be.launch_counts["banded_vg_rows"]
        e, g = be._vg_launch("banded_vg_rows", node, loc, E, NU, W_SUM, rs,
                             grad=grad)
        torch.cuda.synchronize()
        assert be.launch_counts["banded_vg_rows"] == before + 1
        assert _is_plus_zero(g)
        pe, pg = be.banded_vg_plain(node, loc, E, NU, W_SUM, rs)
        assert float(e) == float(pe) and not pg.any()


def _k5_slice_cases():
    """(k, ranks, window_limit) of the K5 slice tests: the 33x17 proxy
    plate's tables for 2, 4 and 8 ranks (the tables' block counts are
    powers of two, so no 3-rank split exists), and for 16 ranks at window
    limit 100, whose last slice places no row."""
    return [(k, r, 300) for r in (2, 4) for k in (3, 4, 6)] + [
        (4, 8, 300), (4, 16, 100)]


def _proxy_plate(dev):
    return dataclasses.replace(pt.proxy_plate_mesh(nx=33, ny=17, device=dev),
                               lattice=None)


@pytest.mark.parametrize("k,ranks,window_limit", _k5_slice_cases(),
                         ids=lambda v: str(v))
def test_banded_bwd_rows_fills_a_nan_output(dev, k, ranks, window_limit):
    """K5 at row_start on each rank's slice into a NaN-filled output through
    the private ``grad=``, one launch a call: the placed rows bit-equal to the whole-table K5's, the whole output
    bit-equal to ct x K4 at the same row_start, every other row +0.0, also
    for a slice that places no row (16 ranks)."""
    ba, node, slices = _rank_slices(_proxy_plate(dev), k, ranks,
                                    window_limit, dev)
    n = node.shape[0]
    ct = torch.tensor(0.75, device=dev)
    no_own = dataclasses.replace(ba, re_own_lo=None, re_own_hi=None)
    g5 = be.banded_bwd(node, no_own, ct, E, NU, W_SUM)
    empty = 0
    for loc, rs in slices:
        loc5 = dataclasses.replace(loc, re_own_lo=None, re_own_hi=None)
        grad = torch.full_like(node, float("nan"))
        before = be.launch_counts["banded_bwd_rows"]
        g = be._bwd_launch("banded_bwd_rows", node, loc5, ct, E, NU, W_SUM,
                           rs, grad=grad)
        assert g is grad
        assert be.launch_counts["banded_bwd_rows"] == before + 1
        _, g4 = be.banded_vg_rows(node, loc, E, NU, W_SUM, rs)
        torch.cuda.synchronize()
        end = min(n, rs + loc.re_inc_rel.shape[0] * loc.re_inc_rel.shape[1])
        empty += end <= rs
        assert torch.equal(g[rs:end], g5[rs:end])
        assert torch.equal(g, ct * g4)
        assert _is_plus_zero(g[:rs]) and _is_plus_zero(g[end:])
    assert empty == (1 if ranks == 16 else 0)


def _bits_equal(a, b):
    """Two float32 tensors equal bit for bit (-0.0 and NaN included)."""
    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def test_row_launches_replay_from_a_cuda_graph(dev):
    """K6 and K7 over a row window, K4 and K5 at row_start, and the
    whole-table K6, K7 and K4, recorded in one CUDA graph and replayed 50
    times over changing inputs: every replay's energies and gradients
    bit-equal to eager calls' on the same inputs, so each launch's energy
    sum finds a new tag (a word left from an earlier replay would be summed
    in place of this one's and return a wrong energy)."""
    nx, ny = 129, 65
    node, kw = _stencil_case(nx, ny, dev)
    lo, hi = 40, 45
    ba, bnode, slices = _rank_slices(
        pt.generate_mesh_delaunay(lc=0.09, device=dev), 3, 4, 300, dev)
    loc, rs = slices[1]
    loc5 = dataclasses.replace(loc, re_own_lo=None, re_own_hi=None)
    ct = torch.tensor(0.75, device=dev)
    static = node.clone()
    bstatic = bnode.clone()

    def calls():
        return [*ls.lattice_stencil_vg_rows(static, nx, ny, E, NU, W_SUM, lo,
                                            hi, **kw),
                ls.lattice_stencil_fwd_rows(static, nx, ny, E, NU, W_SUM, lo,
                                            hi, **kw),
                *ls.lattice_stencil_vg(static, nx, ny, E, NU, W_SUM, **kw),
                ls.lattice_stencil_fwd(static, nx, ny, E, NU, W_SUM, **kw),
                *be.banded_vg_rows(bstatic, loc, E, NU, W_SUM, rs),
                be.banded_bwd_rows(bstatic, loc5, ct, E, NU, W_SUM, rs),
                *be.banded_vg(bstatic, ba, E, NU, W_SUM)]

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):     # warm-up, then the recording
        calls()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=stream):
            recorded = calls()
    torch.cuda.current_stream().wait_stream(stream)
    gen = torch.Generator(device=dev).manual_seed(3)
    for i in range(50):
        scale = 1.0 + 0.01 * torch.randn(1, generator=gen, device=dev)
        static.copy_(node)
        static[:, 2:] *= scale
        bstatic.copy_(bnode)
        bstatic[:, 2:] *= scale
        graph.replay()
        eager = calls()
        torch.cuda.synchronize()
        for j, (got, want) in enumerate(zip(recorded, eager)):
            assert _bits_equal(got, want), (i, j)
        assert float(recorded[0]) == float(recorded[2])     # K6 = K7


def _record(fn):
    """A CUDA graph of ``fn()`` recorded on the current stream (not the
    default one), and its outputs (``torch.cuda.graph`` would also collect
    garbage before each recording)."""
    graph = torch.cuda.CUDAGraph()
    graph.capture_begin()
    try:
        out = fn()
    finally:
        graph.capture_end()
    return graph, out


def test_dropped_graphs_give_their_tail_slots_back(dev):
    """2,500 CUDA graphs recorded in one process, each of K7 and K6 on a
    lattice of 900 tiles (a slot of 1,024 words of the energy sum's 2M),
    replayed once and dropped in turn, while one graph recorded first stays
    alive: more graphs than the words could hold at once, so a graph's
    slot must go back when it is destroyed, and never while it lives.
    Every replay's energies and gradient bit-equal to eager calls'."""
    nx, ny = 700, 249               # 100 x 9 tiles of 7 x 31 nodes
    node, kw = _stencil_case(nx, ny, dev)

    def calls():
        return [ls.lattice_stencil_fwd(node, nx, ny, E, NU, W_SUM, **kw),
                *ls.lattice_stencil_vg(node, nx, ny, E, NU, W_SUM, **kw)]

    want = calls()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls()
        kept, kept_out = _record(calls)
        for i in range(2500):
            graph, out = _record(calls)
            graph.replay()
            if i % 250 == 0:
                kept.replay()
                torch.cuda.synchronize()
                for got, w in zip(kept_out, want):
                    assert _bits_equal(got, w), i
            torch.cuda.synchronize()
            for got, w in zip(out, want):
                assert _bits_equal(got, w), i
            del graph, out
    torch.cuda.current_stream().wait_stream(stream)


@pytest.mark.parametrize("window", [None, (40, 90)], ids=["whole", "rows"])
def test_k6_on_two_streams_at_once(dev, window):
    """K6 launched on two streams at once, 20 calls on each, on two inputs:
    every call's energy and gradient bit-equal to an eager call's on its
    input (each stream takes its own slot of the energy sum, so their
    launches never share a tag or a word)."""
    nx, ny = 129, 65
    a, kw = _stencil_case(nx, ny, dev)
    b = a.clone()
    b[:, 2:] *= 1.01

    def call(nd):
        if window is None:
            return ls.lattice_stencil_vg(nd, nx, ny, E, NU, W_SUM, **kw)
        return ls.lattice_stencil_vg_rows(nd, nx, ny, E, NU, W_SUM, *window,
                                          **kw)

    want = {"a": call(a), "b": call(b)}
    streams = {"a": torch.cuda.Stream(), "b": torch.cuda.Stream()}
    for st in streams.values():
        st.wait_stream(torch.cuda.current_stream())
    got = {"a": [], "b": []}
    for _ in range(20):
        for key, nd in (("a", a), ("b", b)):
            with torch.cuda.stream(streams[key]):
                got[key].append(call(nd))
    for st in streams.values():
        torch.cuda.current_stream().wait_stream(st)
    torch.cuda.synchronize()
    for key in got:
        for e, g in got[key]:
            assert _bits_equal(e, want[key][0])
            assert _bits_equal(g, want[key][1])


def test_two_rank_gloo_slab_on_one_card(dev, tmp_path):
    """Two ranks (gloo) sharing the card run ``shard_map_lattice_slab``:
    value and both gradient groups bit-equal across the ranks and within
    tolerance of the single-rank lattice route, with K6's row variant
    launched on each rank."""
    import json

    from torch_sharded_common import Groups, mesh_arrays

    mesh = pt.generate_mesh(nx=65, ny=33, keep_dead_nodes=True, device=dev)
    rng = np.random.default_rng(6)
    nn = mesh.n_nodes
    params_np = {"coords": mesh.coords.cpu().numpy()
                 + 1e-3 * rng.standard_normal((nn, 2)),
                 "u": 1e-4 * rng.standard_normal((nn, 2))}
    groups = Groups(tmp_path, [(dict(name="slab", fn="slab",
                                     dtype="float32"),
                                mesh_arrays(mesh.to("cpu"), params_np))],
                    worlds=(2,), device="cuda:0")
    try:
        got = groups.case(2, "slab")
        ranks = groups.ranks(2)
    finally:
        groups.close()
    p = pt.params_from_numpy(params_np, device=dev)
    for v in p.values():
        v.requires_grad_(True)
    val = pt.PlaneStressEnergy(model=pt.TriangleP1()).total(p, mesh)
    gc, gu = torch.autograd.grad(val, [p["coords"], p["u"]])
    np.testing.assert_allclose(got["energy"], float(val.detach()), rtol=1e-5)
    for a, b in ((got["g_coords"], gc), (got["g_u"], gu)):
        b = b.cpu().numpy()
        np.testing.assert_allclose(a, b, rtol=5e-4,
                                   atol=1e-5 * np.abs(b).max())
    for r in ranks:
        assert json.loads(str(r["launches"]))["lattice_stencil_vg_rows"] >= 1


# ------------------------------------------------------- the linear solvers
# every coarse lattice of the 961x481 hierarchy, and the CPU tests' sizes
COARSE_SHAPES = [(481, 241), (241, 121), (121, 61), (61, 31), (31, 16),
                 (17, 9), (9, 5)]


@pytest.mark.parametrize("shape", COARSE_SHAPES,
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("diag", [ls.UP, ls.PARITY])
def test_lattice_stencil_kernels_take_fractional_weights(dev, shape, diag):
    """K7 and K6 with the multigrid's coarse quad weights (volume
    fractions in {0, .25, .5, .75, 1}) against their plain versions; K6's
    energy equal to K7's bit for bit."""
    nx, ny = shape
    node, rng = _lattice_node(nx, ny, 11, dev)
    w = torch.tensor(rng.integers(0, 5, (nx - 1, ny - 1)) / 4.0,
                     dtype=torch.float32, device=dev)
    kw = dict(diag=diag, phase=1 if diag == ls.PARITY else 0, t1=w, t2=w)
    e7 = ls.lattice_stencil_fwd(node, nx, ny, E, NU, W_SUM, **kw)
    e6, g6 = ls.lattice_stencil_vg(node, nx, ny, E, NU, W_SUM, **kw)
    ep, gp = ls.lattice_stencil_vg_plain(node, nx, ny, E, NU, W_SUM, **kw)
    assert float(e6) == float(e7)
    _close(e7, ep, rtol=1e-4, atol_scale=0.0)
    _close(g6, gp)


def _mg_plate(nx, ny, dev, split="zigzag", holes=((1.0, 0.5, 0.15),)):
    grid = generate_structured_grid(nx=nx, ny=ny, split=split, holes=holes,
                                    device=dev)
    model = StructuredGridP1(E=10e9, nu=0.3)
    return grid, model, model.init(np.random.default_rng(0), grid,
                                   device=dev)


@pytest.mark.parametrize("shape", [(961, 481), (33, 17)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_level_operator_is_the_autograd_gradient_bit_for_bit(dev, shape):
    """The multigrid level operator calls K6 directly; its gradient equals
    torch.autograd.grad of ``domain_energy`` (which runs K6 through the
    autograd Function) bit for bit, on every level (fractional weights on
    the coarse ones)."""
    from hidenn_fem_tpu_torch.solve import multigrid as tmg

    grid, model, params = _mg_plate(*shape, dev)
    coords = model.coords(params, grid).detach()
    g = grid
    while g is not None and min(g.nx, g.ny) >= 4:
        u = 1e-4 * torch.randn((g.nx, g.ny, 2), device=dev,
                               generator=torch.Generator(dev).manual_seed(1))
        before = ls.launch_counts["lattice_stencil_vg"]
        direct = tmg._level_grad(model, g, coords)(u)
        assert ls.launch_counts["lattice_stencil_vg"] == before + 1
        uu = u.clone().requires_grad_(True)
        (auto,) = torch.autograd.grad(
            model.domain_energy({"coords": coords, "u": uu}, g), uu)
        assert torch.equal(direct, auto), (g.nx, g.ny)
        g = tmg.coarsen_grid(g)
        coords = coords[::2, ::2].contiguous()


def _solve_launches(model, levels, calls, matvecs=0, nu=3,
                    coarse_degree=24):
    """The level kernels' launches (``lattice_slab.LEVEL_KERNELS``) of a
    PCG solve on the card: a fused V(nu, nu) cycle before the loop and
    each of its ``calls`` (``lattice_slab.cycle_launches`` on the levels
    as ``multigrid._vcycle`` takes them), and ``matvecs`` level steps of
    K p."""
    from hidenn_fem_tpu_torch.solve import multigrid as tmg

    cycle = ls.cycle_launches(tmg._fused_levels(
        tmg._level_ops(model, levels), levels, nu, coarse_degree))
    out = {k: (calls + 1) * v for k, v in cycle.items()}
    out["lattice_level_step"] += matvecs
    return out


def _calls(iters, max_iters):
    """Calls of a solver's loop body for ``iters`` iterations: the
    iterations rounded up to a multiple of ``loop.READ_EVERY`` (the
    masked calls past the stop), at most ``max_iters``."""
    from hidenn_fem_tpu_torch.solve import loop

    k = loop.READ_EVERY
    return min(k * -(-iters // k), max_iters)


def test_cg_solve_on_the_card_matches_the_cpu(dev):
    """cg_solve on a banded Delaunay mesh (K4 every matvec) and on a
    lattice plate (K6 every matvec) against the same solve on the CPU's
    plain path: solutions within 1e-4 x max|u| (both f32 solves stop at
    relres 1e-6), energies rtol 1e-5."""
    mesh_cpu = pt.generate_mesh_delaunay(lc=0.09, device="cpu")
    banded = dataclasses.replace(
        mesh_cpu, banded=_banded_tables(mesh_cpu, 3, "cpu"),
        banded_paired=_banded_tables(mesh_cpu, 4, "cpu"))
    lattice = pt.proxy_plate_mesh(nx=41, ny=21, device="cpu")
    for mesh, counter in ((banded, (be, "banded_vg")),
                          (lattice, (ls, "lattice_stencil_vg"))):
        energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

        def loss(p, coords, m):
            return energy({"u": p["u"], "coords": coords}, m)
        u0 = 1e-5 * np.random.default_rng(0).standard_normal(
            (mesh.n_nodes, 2))
        out = {}
        for where in ("cpu", dev):
            m = mesh.to(where)
            u = {"u": torch.tensor(u0, dtype=torch.float32, device=where)}
            mod, name = counter
            before = mod.launch_counts[name]
            sol, hist = pt.cg_solve(loss, u, (m.coords, m), max_iters=2000,
                                    tol=1e-6)
            launched = mod.launch_counts[name] - before
            iters = int((hist > 0).sum())
            assert launched == (0 if where == "cpu"
                                else _calls(iters, 2000) + 1)
            with torch.no_grad():
                out[str(where)] = (sol["u"].cpu(),
                                   float(loss(sol, m.coords, m)))
            assert float(hist[iters - 1]) <= 1e-6
        (uc, ec), (ug, eg) = out["cpu"], out[str(dev)]
        _close(ug, uc, rtol=0.0, atol_scale=1e-4)
        assert abs(eg - ec) <= 1e-5 * abs(ec)


def test_mg_pcg_solve_on_the_card_matches_the_cpu(dev):
    """mg_pcg_solve on the 97x49 zigzag plate with a hole, from u = 0: on
    the card every level operator is a level step (fractional weights on
    the coarse levels) and K6 computes the right-hand side, counted
    exactly; against the same solve on the
    CPU's plain path, solutions within 1e-4 x max|u|.  (From a noise start
    the first residual is the noise's, and relres 1e-6 leaves the two f32
    solutions 2.4e-4 x max|u| apart: measured on the card.)"""
    from hidenn_fem_tpu_torch.solve import multigrid as tmg

    out = {}
    for where in ("cpu", dev):
        grid, model, params = _mg_plate(97, 49, where)
        params["u"] = torch.zeros_like(params["u"])
        names = ("lattice_stencil_vg",) + ls.LEVEL_KERNELS
        before = {k: ls.launch_counts[k] for k in names}
        with torch.no_grad():
            levels = tmg.build_hierarchy(model, grid,
                                         model.coords(params, grid))
        setup = {k: ls.launch_counts[k] - b for k, b in before.items()}
        n_lev = len(levels)
        before = {k: ls.launch_counts[k] for k in names}
        sol, hist = tmg.mg_pcg_solve(model, grid, params, max_iters=40,
                                     tol=1e-6, levels=levels)
        solve = {k: ls.launch_counts[k] - b for k, b in before.items()}
        iters = int((hist > 0).sum())
        assert float(hist[iters - 1]) <= 1e-6
        if where == "cpu":
            assert not any(setup.values()) and not any(solve.values())
        else:
            # set-up: 8 probes and 30 power iterations a level, K v each;
            # solve: K6 the right-hand side, the level kernels of a
            # V(3,3) cycle before the loop and each call of the loop body,
            # and one fine K v each call
            calls = _calls(iters, 40)
            assert setup == {**dict.fromkeys(names, 0),
                             "lattice_level_step": 38 * n_lev}
            assert solve == {"lattice_stencil_vg": 1, **_solve_launches(
                model, levels, calls, matvecs=calls)}
        out[str(where)] = sol["u"].cpu()
    _close(out[str(dev)], out["cpu"], rtol=0.0, atol_scale=1e-4)


# ------------------------------------------------- auxiliary-space PCG
AUX_BOUNDS = {"up": 0, "down": 0, "right": 2, "left": 1}


def _aux_mesh(kind, where):
    """(mesh, lattice_bg) of each background kind on ``where``."""
    if kind in ("reshape", "generic", "windowed"):
        return (pt.proxy_plate_mesh(nx=33, ny=17, device=where),
                kind == "reshape")
    if kind == "perm":
        return pt.generate_mesh(length=2.0, height=1.0,
                                holes=((0.6, 0.5, 0.22),),
                                boundaries=AUX_BOUNDS, nx=33, ny=17,
                                variant="up", device=where), True
    return pt.generate_mesh_hybrid(lc=0.05, holes=((0.6, 0.5, 0.22),),
                                   device=where), True


def _aux_pre(kind, where):
    from hidenn_fem_tpu_torch.solve import auxspace as tax

    mesh, lattice_bg = _aux_mesh(kind, where)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)

    up = {"u": torch.tensor(u0, dtype=torch.float32, device=where)}
    pre = tax.build_aux_preconditioner(loss, up, (mesh.coords, mesh), mesh,
                                       bg_model=StructuredGridP1(E=E, nu=NU),
                                       lattice_bg=lattice_bg)
    if kind == "windowed":
        rel, w, starts, width = tax._windowed_pt(
            pre.pt_idx.reshape(pre.pt_w.shape).cpu().numpy(),
            pre.pt_w.cpu().numpy(), mesh.n_nodes, pre.grid.nx, pre.grid.ny)
        pre = dataclasses.replace(
            pre, ptw_rel=torch.tensor(rel, device=where),
            ptw_w=torch.tensor(w, device=where),
            ptw_starts=torch.tensor(starts, device=where).long(),
            ptw_width=width)
    return mesh, pre


@pytest.mark.parametrize("kind", ["reshape", "generic", "windowed", "perm",
                                  "hybrid"])
def test_apply_aux_on_the_card_matches_the_cpu(dev, kind):
    """``_apply_aux`` on each background kind: on the card each V-cycle
    launches no K6 and its level kernels exactly (``_solve_launches``), and
    two applications are bit-equal (the hybrid rim's ``index_add`` has
    one addend a row); against the CPU's plain path within 1e-4 x max|z|
    (38-41 level operators of f32 sums in other orders)."""
    from hidenn_fem_tpu_torch.solve import auxspace as tax

    bg = StructuredGridP1(E=E, nu=NU)
    out = {}
    for where in ("cpu", dev):
        mesh, pre = _aux_pre(kind, where)
        r = torch.tensor(np.random.default_rng(1).standard_normal(
            (mesh.n_nodes, 2)), dtype=torch.float32, device=where)
        names = ("lattice_stencil_vg",) + ls.LEVEL_KERNELS
        before = {k: ls.launch_counts[k] for k in names}
        z = tax._apply_aux(bg, pre, r)
        launched = {k: ls.launch_counts[k] - b for k, b in before.items()}
        assert launched == {**dict.fromkeys(names, 0), **(
            {} if where == "cpu" else _solve_launches(bg, pre.levels, 0))}
        assert torch.equal(z, tax._apply_aux(bg, pre, r))
        out[str(where)] = z.cpu()
    _close(out[str(dev)], out["cpu"], rtol=0.0, atol_scale=1e-4)


def test_aux_pcg_solve_on_the_card_matches_the_cpu(dev):
    """aux_pcg_solve from u = 0 on the 41x21 proxy plate (lattice route
    and lattice-aligned background: K6 each matvec, the level steps each
    V-cycle) and on a banded Delaunay plate (K4 each matvec, the level
    steps in the V-cycle on the generic background), launches counted
    exactly; against the CPU's plain path within 1e-4 x max|u|."""
    from hidenn_fem_tpu_torch.solve import auxspace as tax

    delaunay = pt.generate_mesh_delaunay(lc=0.09, device="cpu")
    delaunay = dataclasses.replace(
        delaunay, banded=_banded_tables(delaunay, 3, "cpu"),
        banded_paired=_banded_tables(delaunay, 4, "cpu"))
    lattice = pt.proxy_plate_mesh(nx=41, ny=21, device="cpu")
    for mesh, fine in ((lattice, (ls, "lattice_stencil_vg")),
                       (delaunay, (be, "banded_vg"))):
        energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

        def loss(p, coords, m):
            return energy({"u": p["u"], "coords": coords}, m)

        out = {}
        for where in ("cpu", dev):
            m = mesh.to(where)
            up = {"u": torch.zeros((m.n_nodes, 2), device=where)}
            pre = tax.build_aux_preconditioner(
                loss, up, (m.coords, m), m,
                bg_model=StructuredGridP1(E=E, nu=NU))
            counters = {"k6": (ls, "lattice_stencil_vg"), "fine": fine,
                        **{k: (ls, k) for k in ls.LEVEL_KERNELS}}
            before = {k: mod.launch_counts[c]
                      for k, (mod, c) in counters.items()}
            sol, hist = tax.aux_pcg_solve(loss, up, (m.coords, m), pre=pre,
                                          max_iters=200, tol=1e-6)
            got = {k: mod.launch_counts[c] - before[k]
                   for k, (mod, c) in counters.items()}
            iters = int((hist > 0).sum())
            assert float(hist[iters - 1]) <= 1e-6
            if where == "cpu":
                assert not any(got.values())
            else:
                # the fine gradient at the start and one matvec a call of
                # the loop body; a V-cycle's level kernels before the loop
                # and each call
                calls = _calls(iters, 200)
                steps = _solve_launches(pre.bg_model, pre.levels, calls)
                k6 = 1 + calls if fine[1] == "lattice_stencil_vg" else 0
                assert got == {"k6": k6, "fine": 1 + calls, **steps}
            out[str(where)] = sol["u"].cpu()
        _close(out[str(dev)], out["cpu"], rtol=0.0, atol_scale=1e-4)


def test_aux_pcg_float64_on_the_card_takes_the_plain_path(dev):
    """A float64 solve (f64 energy and background model) launches no K6
    and no level step (the level operator takes them for CUDA float32
    only) and reaches
    relres 1e-10, within 1e-8 x max|u| of the same solve on the CPU."""
    from hidenn_fem_tpu_torch.solve import auxspace as tax

    out = {}
    for where in ("cpu", dev):
        mesh = pt.proxy_plate_mesh(nx=33, ny=17, device=where,
                                   dtype=torch.float64)
        energy = pt.PlaneStressEnergy(
            model=pt.TriangleP1(dtype=torch.float64))

        def loss(p, coords, m):
            return energy({"u": p["u"], "coords": coords}, m)

        up = {"u": torch.zeros((mesh.n_nodes, 2), dtype=torch.float64,
                               device=where)}
        names = ("lattice_stencil_vg",) + ls.LEVEL_KERNELS
        before = [ls.launch_counts[k] for k in names]
        sol, hist = tax.aux_pcg_solve(
            loss, up, (mesh.coords, mesh), mesh=mesh,
            bg_model=StructuredGridP1(E=E, nu=NU, dtype=torch.float64),
            max_iters=400, tol=1e-10)
        assert [ls.launch_counts[k] for k in names] == before
        iters = int((hist > 0).sum())
        assert sol["u"].dtype == torch.float64
        assert float(hist[iters - 1]) <= 1e-10
        out[str(where)] = sol["u"].cpu()
    _close(out[str(dev)], out["cpu"], rtol=0.0, atol_scale=1e-8)


def test_two_rank_gloo_aux_pcg_on_one_card(dev, tmp_path):
    """Two ranks (gloo) sharing the card solve the proxy plate with its
    lattice stripped by ``aux_pcg_solve_sharded``: the banded route
    rebanded for 2 ranks (K4 at row_start each matvec) and a replicated
    V-cycle (the level steps); solutions and histories bit-equal across
    the ranks and
    within 5e-3 x max|u| of the single-rank solve (the JAX test's bound),
    iterations within 6."""
    import json

    from torch_sharded_common import Groups, mesh_arrays

    mesh = dataclasses.replace(pt.proxy_plate_mesh(nx=65, ny=33,
                                                   device="cpu"),
                               lattice=None)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    groups = Groups(tmp_path, [(dict(name="aux", fn="aux", dtype="float32",
                                     max_iters=100, tol=1e-6),
                                mesh_arrays(mesh, {"coords": mesh.coords,
                                                   "u": u0}))],
                    worlds=(2,), device="cuda:0")
    try:
        got = groups.case(2, "aux")
        ranks = groups.ranks(2)
    finally:
        groups.close()
    m = mesh.to(dev)
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

    def loss(p, coords, mm):
        return energy({"u": p["u"], "coords": coords}, mm)

    sol, hist = pt.aux_pcg_solve(
        loss, {"u": torch.tensor(u0, dtype=torch.float32, device=dev)},
        (m.coords, m), mesh=m, bg_model=StructuredGridP1(E=E, nu=NU),
        max_iters=100, tol=1e-6)
    h0, h1 = hist.cpu().numpy(), got["hist"]
    assert h1[h1 > 0][-1] <= 1e-6
    assert abs(int((h1 > 0).sum()) - int((h0 > 0).sum())) <= 6
    u = sol["u"].cpu().numpy()
    assert np.abs(got["u"] - u).max() <= 5e-3 * np.abs(u).max()
    for r in ranks:
        launched = json.loads(str(r["launches"]))
        assert launched["banded_vg_rows"] >= 1
        assert sum(launched.get(k, 0) for k in ls.LEVEL_KERNELS) >= 1


# ------------------------------------------------ the sharded multigrid
@pytest.mark.parametrize("shape,ranks", [((961, 481), 4), ((33, 17), 2),
                                         ((65, 33), 4)],
                         ids=lambda v: str(v))
def test_sharded_level_operator_is_the_whole_level_k6(dev, shape, ranks):
    """On a level padded with dead rows for ``ranks`` ranks (zigzag, a
    hole: the padding moves the parity), K6 over each rank's row window,
    its displacement rows placed and summed over the windows (what the
    sharded level operator's ``all_reduce`` adds), equals the whole-level
    K6's displacement gradient bit for bit."""
    from hidenn_fem_tpu_torch.parallel import sharded_mg as smg
    from hidenn_fem_tpu_torch.parallel.sharded_slab import row_window

    grid, model, params = _mg_plate(*shape, dev)
    coords = model.coords(params, grid).detach()
    gP, cP, uP, k = smg._pad(grid, coords, params["u"], ranks)
    assert k != 0 and gP.nx % ranks == 0
    nx, ny = gP.nx, gP.ny
    node = torch.cat([model.coords({"coords": cP}, gP),
                      model.u_full({"u": uP}, gP)], dim=-1).reshape(-1, 4)
    kw = ls.structured_stencil(gP.quad_mask, gP.split, gP.zigzag_phase,
                               torch.float32)
    _, whole = ls.lattice_stencil_vg(node, nx, ny, E, NU, 0.5, **kw)
    summed = torch.zeros((nx * ny, 2), device=dev)
    before = ls.launch_counts["lattice_stencil_vg_rows"]
    for r in range(ranks):
        lo, hi = row_window(nx, r, ranks)
        _, g = ls.lattice_stencil_vg_rows(node, nx, ny, E, NU, 0.5, lo, hi,
                                          **kw)
        summed += g[:, 2:]
    assert ls.launch_counts["lattice_stencil_vg_rows"] - before == ranks
    assert torch.equal(summed, whole[:, 2:].contiguous())


@pytest.mark.parametrize("engine", ["all", "replicated_coarse"])
def test_two_rank_gloo_sharded_mg_on_one_card(dev, tmp_path, engine):
    """Two ranks (gloo) sharing the card solve the 65x33 zigzag plate with
    a hole by ``mg_pcg_solve_sharded``: K6 over a row window on the
    sharded levels; solutions and histories bit-equal across the ranks,
    within 3 iterations and 5e-4 x max|u| of the single-process
    ``mg_pcg_solve`` on the card (the JAX test's bounds; on the CPU the
    same case takes 13 or 14 iterations against 13); the
    ``all_reduce`` calls equal ``count_collectives``' census when the
    solve runs to its cap."""
    import json

    from hidenn_fem_tpu_torch.parallel import sharded_mg as smg
    from torch_sharded_common import Groups

    hole = [[1.0, 0.5, 0.15]]
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((65, 33, 2))
    common = dict(fn="mg", dtype="float32", nx=65, ny=33, split="zigzag",
                  holes=hole, engine=engine)
    groups = Groups(tmp_path, [
        (dict(name="solve", max_iters=40, tol=1e-6, **common), {"p_u": u0}),
        (dict(name="census", max_iters=4, tol=0.0, **common), {"p_u": u0})],
        worlds=(2,), device="cuda:0")
    try:
        got = groups.case(2, "solve")
        census = groups.case(2, "census")
        ranks = groups.ranks(2)
    finally:
        groups.close()
    grid, model, _ = _mg_plate(65, 33, dev)
    params = {"coords": grid.coords,
              "u": torch.tensor(u0, dtype=torch.float32, device=dev)}
    sol, hist = pt.mg_pcg_solve(model, grid, params, max_iters=40, tol=1e-6)
    h0, h1 = hist.cpu().numpy(), got["hist"]
    assert h1[h1 > 0][-1] <= 1e-6
    assert abs(int((h1 > 0).sum()) - int((h0 > 0).sum())) <= 3
    u = sol["u"].cpu().numpy()
    assert np.abs(got["u"] - u).max() <= 5e-4 * np.abs(u).max()
    want = smg.count_collectives(model, grid, params, n_devices=2,
                                 engine=engine, max_iters=4)
    assert int(census["all_reduce"]) == want["all_reduce"]
    for r in ranks:
        assert json.loads(str(r["launches"]))["lattice_stencil_vg_rows"] > 0


# ------------------------------------ two-loop and zoom L-BFGS, profiling
@pytest.mark.parametrize("mode,linesearch", [("scan", "none"),
                                             ("compact", "zoom")])
def test_lbfgs_variants_on_the_card_match_the_cpu(dev, mode, linesearch):
    """``lbfgs(mode="scan")`` and the zoom line search on the 33x17 proxy
    plate (the lattice route: K6 each value-and-grad on the card), 30
    steps, against the same run on the CPU: the energy at init within
    rtol 1e-4 and after 30 steps within the f32 spread rule (5e-3)."""
    from hidenn_fem_tpu_torch.solve import optimizers as topt
    from hidenn_fem_tpu_torch.solve.drivers import run_optimizer

    out = {}
    for where in ("cpu", dev):
        mesh = pt.proxy_plate_mesh(nx=33, ny=17, device=where)
        u0 = 1e-5 * np.random.default_rng(0).standard_normal(
            (mesh.n_nodes, 2))
        params = pt.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                       "u": u0}, device=where)
        energy = pt.PlaneStressEnergy(model=pt.TriangleP1())
        opt = topt.lbfgs(memory_size=10, mode=mode, linesearch=linesearch)
        before = ls.launch_counts["lattice_stencil_vg"]
        _, losses = run_optimizer(energy.total, params, opt, 30,
                                  loss_args=(mesh,))
        launched = ls.launch_counts["lattice_stencil_vg"] - before
        assert launched == 0 if where == "cpu" else launched >= 30
        out[str(where)] = losses.cpu().numpy()
    got, want = out[str(dev)], out["cpu"]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    np.testing.assert_allclose(got[-1], want[-1], rtol=5e-3)


def test_slope_time_scan_around_k6(dev):
    """``slope_time_scan`` of a K6 step on the 961x481 lattice: a finite
    positive time, every step one K6 launch ((1 + repeats) (n1 + n2)
    launches in all)."""
    from hidenn_fem_tpu_torch.utils.profiling import slope_time_scan

    grid, model, params = _mg_plate(961, 481, dev, split="up", holes=())
    node = torch.cat([grid.coords, params["u"]], dim=-1).reshape(-1, 4)
    kw = ls.structured_stencil(grid.quad_mask, "up", 0, torch.float32)

    def step(n):
        e, g = ls.lattice_stencil_vg(n, 961, 481, E, NU, 0.5, **kw)
        return n - 1e-15 * g, e

    before = ls.launch_counts["lattice_stencil_vg"]
    t = slope_time_scan(step, node.contiguous(), n1=5, n2=25, repeats=2)
    assert np.isfinite(t) and t > 0
    assert ls.launch_counts["lattice_stencil_vg"] - before == 3 * 30


# ------------------------ slice 10: 1D/bilinear models, point evaluation
def _example3_force(x):
    import math
    n1 = 4 * math.pi ** 2 * (x - 2.5) ** 2 - 2 * math.pi
    n2 = 8 * math.pi ** 2 * (x - 7.5) ** 2 - 4 * math.pi
    return (-n1 * torch.exp(-math.pi * (x - 2.5) ** 2)
            - n2 * torch.exp(-math.pi * (x - 7.5) ** 2))


def _vg(loss, params):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    val = loss(p)
    keys = sorted(p)
    grads = torch.autograd.grad(val, [p[k] for k in keys])
    return float(val.detach()), {k: g.cpu() for k, g in zip(keys, grads)}


def test_1d_and_bilinear_models_on_the_card_match_the_cpu(dev):
    """``Linear1D`` with the L2 loss and ``bar_energy_1d`` (both gradient
    groups, through the double derivative), and ``Bilinear2D`` with the
    L2 loss, on the card against the CPU from the same params: values
    rtol 1e-5, gradients rtol 5e-4 with atol 1e-5 x max|g| (f32 sums in
    another order)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, 500)
    u = rng.normal(size=87) * 1e-3
    inc = np.full(88, 10 / 88) * np.exp(0.2 * rng.normal(size=88))
    pts = rng.uniform(0, 1, (400, 2))
    u2 = rng.standard_normal((9, 7))
    out = {}
    for where in ("cpu", dev):
        m1, p1 = pt.Linear1D.from_node_coords(
            np.linspace(0, 10, 89), r_adapt=True, u0=0.0, uN=0.0,
            device=where)
        p1 = {"u": torch.tensor(u, dtype=torch.float32, device=where),
              "x_increments": torch.tensor(inc, dtype=torch.float32,
                                           device=where)}
        xt = torch.tensor(x, dtype=torch.float32, device=where)
        l2 = _vg(lambda p: pt.l2_loss(m1, p, xt, torch.sin(xt)), p1)
        bar = _vg(lambda p: pt.bar_energy_1d(m1, p, 2, _example3_force,
                                             E=175.0), p1)
        m2, p2 = pt.Bilinear2D.create(np.linspace(0, 1, 9),
                                      np.linspace(0, 1, 7), r_adapt=True,
                                      device=where)
        p2["u"] = torch.tensor(u2, dtype=torch.float32, device=where)
        pq = torch.tensor(pts, dtype=torch.float32, device=where)
        bil = _vg(lambda p: pt.l2_loss(m2, p, pq, pq[:, 0] * pq[:, 1]), p2)
        out[str(where)] = (l2, bar, bil)
    for (vc, gc), (vd, gd) in zip(out["cpu"], out[str(dev)]):
        np.testing.assert_allclose(vd, vc, rtol=1e-5)
        for k in gc:
            _close(gd[k], gc[k])


def test_evaluate_at_points_on_the_card_matches_the_cpu(dev):
    """Point location and evaluation on the card (the bucket grid in
    torch on the card) against the CPU on a holed plate: the same
    elements and -1 set, values rtol 1e-6, NaN outside."""
    from hidenn_fem_tpu_torch import postproc

    rng = np.random.default_rng(1)
    pts = np.stack([rng.uniform(-0.1, 2.1, 20000),
                    rng.uniform(-0.1, 1.1, 20000)], axis=1)
    out = {}
    for where in ("cpu", dev):
        mesh = pt.generate_mesh(nx=81, ny=41, device=where)
        model = pt.TriangleP1()
        params = model.init(torch.Generator().manual_seed(0), mesh,
                            device=where)
        eid, _ = postproc.locate_points(model.coords(params, mesh),
                                        mesh.connectivity, pts)
        assert eid.device.type == torch.device(where).type
        val = postproc.evaluate_at_points(model, params, mesh, pts)
        out[str(where)] = (eid.cpu().numpy(), val.cpu().numpy())
    (ec, vc), (ed, vd) = out["cpu"], out[str(dev)]
    np.testing.assert_array_equal(ed, ec)
    np.testing.assert_array_equal(np.isnan(vd), np.isnan(vc))
    ok = ec >= 0
    assert 0 < ok.sum() < len(ok)
    np.testing.assert_allclose(vd[ok], vc[ok], rtol=1e-6, atol=1e-12)


# ------------------------------ the captured optimizer step (CUDA graphs)
def _plate_case(mesh, dev, seed=0, **energy_kw):
    u0 = 1e-5 * np.random.default_rng(seed).standard_normal(
        (mesh.n_nodes, 2))
    params = pt.params_from_numpy({"coords": mesh.coords.cpu().numpy(),
                                   "u": u0}, device=dev)
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1(), **energy_kw)
    return energy.total, params, (mesh,)


def _capture_case(name, dev):
    """(drive, kernels that must launch) of one captured path: ``drive()``
    returns (params, history) through the public drivers."""
    from tools.profile_torch_port import without_recompute

    lat = pt.proxy_plate_mesh(nx=33, ny=17, device=dev)
    steps = 20
    if name in ("lattice", "gather", "banded", "banded_k5", "hybrid",
                "renumbered"):
        mesh, needs = {
            "lattice": (lat, ("lattice_stencil_vg",)),
            "gather": (dataclasses.replace(lat, lattice=None),
                       ("element_energy_fwd", "element_energy_bwd",
                        "incidence_sum")),
            "hybrid": (pt.generate_mesh_hybrid(
                lc=0.05, holes=((0.6, 0.5, 0.22),), device=dev), ()),
            "renumbered": (pt.generate_mesh(
                nx=33, ny=17, holes=((0.6, 0.5, 0.22),), device=dev), ()),
        }.get(name, (None, ("banded_vg",)))
        if mesh is None:
            mesh = pt.generate_mesh_delaunay(lc=0.09, device=dev)
            paired = _banded_tables(mesh, 4, dev)
            if name == "banded_k5":
                paired = without_recompute(paired, True)
                needs = ("banded_bwd",)
            mesh = dataclasses.replace(
                mesh, banded=_banded_tables(mesh, 3, dev),
                banded_paired=paired)
        loss, params, args = _plate_case(mesh, dev)
        return (lambda: pt.run_lbfgs(loss, params, num_steps=steps,
                                     memory_size=10, loss_args=args),
                needs)
    if name == "structured":
        grid = generate_structured_grid(holes=((1.0, 0.5, 0.2),), nx=33,
                                        ny=17, device=dev)
        model = StructuredGridP1()
        p = model.init(np.random.default_rng(0), grid, device=dev)
        return (lambda: pt.run_lbfgs(model.total, p, num_steps=steps,
                                     memory_size=10, loss_args=(grid,)),
                ("lattice_stencil_vg",))
    loss, params, args = _plate_case(lat, dev)
    if name == "two_loop":
        from hidenn_fem_tpu_torch.solve import optimizers as topt
        return (lambda: pt.run_optimizer(
            loss, params, topt.lbfgs(memory_size=10, mode="scan"), steps,
            loss_args=args), ("lattice_stencil_vg",))
    if name == "adam_per_group":
        return (lambda: pt.minimize(loss, params, method="adam",
                                    num_steps=steps, loss_args=args,
                                    group_lrs={"u": 1e-6,
                                               "coords": 1e-7}),
                ("lattice_stencil_vg",))
    if name == "alternating":
        return (lambda: pt.alternating_solve(
            lambda p: loss(p, lat), params, outer_epochs=4, u_steps=5,
            coord_steps=4), ("lattice_stencil_vg",))
    if name == "node_space":
        return (lambda: pt.lbfgs_node_space(
            pt.PlaneStressEnergy(model=pt.TriangleP1()), params, lat,
            num_steps=steps), ("lattice_stencil_vg",))
    if name == "bar_1d":          # example 3's loss: a double backward
        m1, p1 = pt.Linear1D.from_node_coords(
            np.linspace(0, 10, 89), r_adapt=True, u0=0.0, uN=0.0,
            device=dev)
        return (lambda: pt.minimize(
            lambda p: pt.bar_energy_1d(m1, p, 2, _example3_force, E=175.0),
            p1, method="adam", num_steps=steps, learning_rate=1e-4), ())
    if name == "bilinear":
        m2, p2 = pt.Bilinear2D.create(np.linspace(0, 1, 9),
                                      np.linspace(0, 1, 7), r_adapt=True,
                                      device=dev)
        pq = torch.rand((400, 2), generator=torch.Generator().manual_seed(
            0)).to(dev)
        return (lambda: pt.minimize(
            lambda p: pt.l2_loss(m2, p, pq, pq[:, 0] * pq[:, 1]), p2,
            method="adam", num_steps=steps, learning_rate=1e-3), ())
    raise ValueError(name)


def _launched(before):
    from hidenn_fem_tpu_torch.solve import loop
    return [{k: c[k] - b[k] for k in c}
            for c, b in zip(loop._counters(), before)]


def _drive(drive, monkeypatch, capture):
    """One run of ``drive`` with the capture on or off; returns (flat
    params, history, every counter's launches)."""
    from hidenn_fem_tpu_torch.solve import drivers, loop

    with monkeypatch.context() as mp:
        if not capture:
            mp.setattr(drivers, "_capturable", lambda *a: False)
        before = [dict(c) for c in loop._counters()]
        params, hist = drive()
        torch.cuda.synchronize()
    flat = params if isinstance(params, torch.Tensor) else torch.cat(
        [params[k].reshape(-1) for k in sorted(params)])
    return flat, hist, _launched(before)


@pytest.mark.parametrize("name", [
    "lattice", "gather", "banded", "banded_k5", "hybrid", "renumbered",
    "structured", "two_loop", "adam_per_group", "alternating",
    "node_space", "bar_1d", "bilinear"])
def test_captured_step_matches_the_eager_step(dev, monkeypatch, name):
    """Each path through the drivers, captured (one CUDA graph a step,
    replayed) against the same steps run eagerly on the card, from the
    same inputs: where two eager runs are bit-equal (every kernel route;
    the kernels sum without atomics) the captured history and params are
    bit-equal too, else within the f32 spread rule (5e-3); every counter
    moves as the eager run's (the captured launches times the replays),
    and each kernel of the path launched."""
    drive, needs = _capture_case(name, dev)
    e1, e2, cap = (_drive(drive, monkeypatch, c)
                   for c in (False, False, True))
    assert torch.isfinite(cap[1]).all()
    assert cap[2] == e1[2], (cap[2], e1[2])
    launched = {k: v for c in cap[2] for k, v in c.items()}
    for k in needs:
        assert launched[k] > 0, k
    if name in ("lattice", "gather", "banded", "banded_k5", "structured",
                "two_loop", "adam_per_group", "alternating",
                "node_space"):
        assert torch.equal(e1[0], e2[0]) and torch.equal(e1[1], e2[1])
    if torch.equal(e1[0], e2[0]) and torch.equal(e1[1], e2[1]):
        assert torch.equal(cap[1], e1[1]) and torch.equal(cap[0], e1[0])
    else:
        _close(cap[1], e1[1], rtol=5e-3, atol_scale=0.0)


def _gmax_sequence(loss, params, args, opt, steps):
    """max|g| of each step of an eager run, from the same inputs."""
    from hidenn_fem_tpu_torch.solve import drivers

    vg = drivers._value_and_grad(loss, params, args)
    leaf = drivers._leaf(params)
    state = opt.init(leaf.detach(), like=params)
    out = []
    for _ in range(steps):
        _, g, state = drivers._step(vg, opt, leaf, state)
        out.append(float(g.abs().max()))
    return out


def test_captured_tol_stops_at_the_eager_step(dev, monkeypatch):
    """``tol`` on the lattice route, set between two gradient norms of
    the run so the stop falls after the capture: the captured run (one
    flag read a replay) stops at the eager run's step, with the same
    bits and the same padding."""
    from hidenn_fem_tpu_torch.solve import optimizers as topt

    lat = pt.proxy_plate_mesh(nx=33, ny=17, device=dev)
    loss, params, args = _plate_case(lat, dev, E=1.0, F_total=1e-2)
    gm = _gmax_sequence(loss, params, args, topt.lbfgs(memory_size=10), 40)
    j = next(j for j in range(5, 40) if gm[j] < min(gm[:j]))
    tol = 0.5 * (gm[j] + min(gm[:j]))
    drive = lambda: pt.run_lbfgs(loss, params, num_steps=40,  # noqa: E731
                                 memory_size=10, tol=tol, loss_args=args)
    (pe, he, ne), (pc, hc, nc) = (_drive(drive, monkeypatch, c)
                                  for c in (False, True))
    assert torch.equal(hc, he) and torch.equal(pc, pe) and nc == ne
    assert torch.all(hc[j:] == hc[j]) and hc[j] != hc[j - 1]
    assert ne[1]["lattice_stencil_vg"] == j + 1


def test_steady_state_step_makes_no_host_sync(dev):
    """After the first call, a step (value-and-grad through K6, the
    compact L-BFGS update, the history write) runs under
    ``set_sync_debug_mode("error")``; a loss that reads the device from
    the host makes ``run_lbfgs`` raise instead of falling back."""
    from hidenn_fem_tpu_torch.solve import drivers
    from hidenn_fem_tpu_torch.solve import optimizers as topt

    lat = pt.proxy_plate_mesh(nx=33, ny=17, device=dev)
    loss, params, args = _plate_case(lat, dev)
    opt = topt.lbfgs(memory_size=10)
    leaf = drivers._leaf(params)
    stepper = drivers._Stepper(drivers._value_and_grad(loss, params, args),
                               opt, leaf, opt.init(leaf.detach()),
                               n_hist=8, capture=False)
    stepper.run(1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stepper.run(4)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert stepper.state.count == 5

    def reads(p, mesh):
        e = loss(p, mesh)
        return e * (1.0 + 0.0 * float(e))
    with pytest.raises(RuntimeError, match="synchronizes with the host"):
        pt.run_lbfgs(reads, params, num_steps=5, loss_args=args)


# ------------------------ the captured solver loops (one CUDA graph an
# iteration, replayed; the stop flag read every loop.READ_EVERY replays)
SOLVER_CASES = ["cg_lattice", "cg_banded", "jacobi_lattice", "jacobi_banded",
                "mg", "aux_lattice", "aux_banded"]


def _solver_drive(name, dev):
    """(drive, kernels that must launch) of one solver from rest:
    ``drive()`` returns (solution u, history) through the public solver;
    hierarchies and preconditioners are built once, outside it."""
    if name == "mg":
        grid, model, params = _mg_plate(97, 49, dev)
        params["u"] = torch.zeros_like(params["u"])
        with torch.no_grad():
            levels = pt.build_hierarchy(model, grid,
                                        model.coords(params, grid))

        def drive():
            sol, h = pt.mg_pcg_solve(model, grid, params, max_iters=40,
                                     tol=1e-6, levels=levels)
            return sol["u"], h
        return drive, ("lattice_stencil_vg", "lattice_level_step")
    if name.endswith("lattice"):
        mesh, needs = (pt.proxy_plate_mesh(nx=41, ny=21, device=dev),
                       ("lattice_stencil_vg",))
    else:
        mesh = pt.generate_mesh_delaunay(lc=0.09, device=dev)
        mesh = dataclasses.replace(
            mesh, banded=_banded_tables(mesh, 3, dev),
            banded_paired=_banded_tables(mesh, 4, dev))
        needs = ("banded_vg",)
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

    def loss(p, coords, m):
        return energy({"u": p["u"], "coords": coords}, m)
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    args = (mesh.coords, mesh)
    if name.startswith("aux"):
        pre = pt.build_aux_preconditioner(
            loss, u0, args, mesh, bg_model=StructuredGridP1(E=E, nu=NU))
        solve = functools.partial(pt.aux_pcg_solve, pre=pre, max_iters=200)
        needs = needs + ("lattice_bottom_cycle",)
    elif name.startswith("jacobi"):
        solve = functools.partial(pt.jacobi_pcg_solve, mesh=mesh,
                                  max_iters=2000)
    else:
        solve = functools.partial(pt.cg_solve, max_iters=2000)

    def drive():
        sol, h = solve(loss, u0, args, tol=1e-6)
        return sol["u"], h
    return drive, needs


def _solver_run(drive, monkeypatch, capture):
    """One run of ``drive`` with the capture on or off: (u, history,
    every counter's launches, graphs recorded)."""
    from hidenn_fem_tpu_torch.solve import loop

    with monkeypatch.context() as mp:
        if not capture:
            mp.setattr(loop, "capturable", lambda device: False)
        before = [dict(c) for c in loop._counters()]
        graphs = loop.captures["graphs"]
        u, h = drive()
        torch.cuda.synchronize()
    return u, h, _launched(before), loop.captures["graphs"] - graphs


@pytest.mark.parametrize("name", SOLVER_CASES)
def test_captured_solver_matches_the_eager_solver(dev, monkeypatch, name):
    """Each solver's iterations replayed from one CUDA graph against the
    same body run eagerly on the card: two eager runs are bit-equal (the
    kernels sum without atomics), and so is the captured run, history and
    solution; every counter moves as in the eager run (the captured
    launches times the replays, the masked ones included), each kernel
    of the path launched, and the solve reached relres 1e-6."""
    drive, needs = _solver_drive(name, dev)
    e1, e2, cap = (_solver_run(drive, monkeypatch, c)
                   for c in (False, False, True))
    assert e1[3] == e2[3] == 0 and cap[3] == 1
    assert torch.equal(e1[0], e2[0]) and torch.equal(e1[1], e2[1])
    assert torch.equal(cap[0], e1[0]) and torch.equal(cap[1], e1[1])
    assert cap[2] == e1[2], (cap[2], e1[2])
    launched = {k: v for c in cap[2] for k, v in c.items()}
    for k in needs:
        assert launched[k] > 0, k
    h = cap[1].cpu().numpy()
    assert h[h > 0][-1] <= 1e-6 and np.all(h[int((h > 0).sum()):] == 0)


def test_solver_body_with_a_host_read_raises(dev):
    """The warm-up iteration runs under ``set_sync_debug_mode("error")``:
    a loss that reads the device from the host makes ``cg_solve`` raise
    instead of running the loop eagerly."""
    mesh = pt.proxy_plate_mesh(nx=41, ny=21, device=dev)
    energy = pt.PlaneStressEnergy(model=pt.TriangleP1())

    def reads(p, coords, m):
        e = energy({"u": p["u"], "coords": coords}, m)
        return e * (1.0 + 0.0 * float(e))
    u0 = {"u": torch.zeros((mesh.n_nodes, 2), device=dev)}
    with pytest.raises(RuntimeError, match="synchronizes with the host"):
        pt.cg_solve(reads, u0, (mesh.coords, mesh), max_iters=50)


def test_one_nccl_rank_sharded_mg_is_captured(dev, monkeypatch):
    """``mg_pcg_solve_sharded`` on a one-rank NCCL group (every sharded
    level operator an ``all_reduce``, recorded in the graph): the captured
    solve is bit-equal to the eager one, and both issue the
    ``all_reduce`` calls of ``count_collectives`` for the loop body's
    calls."""
    from hidenn_fem_tpu_torch.parallel import (device_mesh,
                                               initialize_multihost,
                                               sharded_mg)
    from torch_sharded_common import free_port

    grid, model, params = _mg_plate(65, 33, dev)
    initialize_multihost(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        dmesh = device_mesh(device=dev)

        def drive():
            sol, h = sharded_mg.mg_pcg_solve_sharded(
                model, grid, params, dmesh=dmesh, max_iters=40, tol=1e-6)
            return sol["u"], h

        eager, cap = (_solver_run(drive, monkeypatch, c)
                      for c in (False, True))
    finally:
        torch.distributed.destroy_process_group()
    assert eager[3] == 0 and cap[3] == 1
    assert torch.equal(cap[0], eager[0]) and torch.equal(cap[1], eager[1])
    assert cap[2] == eager[2]
    iters = int((cap[1] > 0).sum())
    want = sharded_mg.count_collectives(model, grid, params, n_devices=1,
                                        max_iters=_calls(iters, 40))
    assert cap[2][-1]["all_reduce"] == want["all_reduce"] > 0


# ------------------------------ the compact L-BFGS's history passes
# (ops/lbfgs_history.py): (m, P) from the unit sizes to example 4
# (81,204), the 898K plate (1,803,696) and example 6 (m = 10, 2,000,000)
HISTORY_SHAPES = [(1, 1), (3, 7), (8, 4097), (100, 81_204),
                  (100, 1_803_696), (10, 2_000_000)]
# per entry, of the same sum over absolute values: float32 1e-5, float64
# 1e-13 (sums in other orders; S.g may cancel)
HISTORY_RTOL = {torch.float32: 1e-5, torch.float64: 1e-13}


def _history_inputs(m, p, dtype, dev, seed=0):
    """SY [2m, P] with one zero (rejected) pair for m > 1, y, s, g [P],
    coef [2m], gamma (0-dim), all on ``dev``."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)
    SY = randn(2 * m, p)
    if m > 1:
        SY[[1, m + 1]] = 0.0
    y, s, g = randn(p), randn(p), randn(p)
    return SY, y, s, g, randn(2 * m), randn().abs() + 0.1


def _within(got, want, scale, rtol):
    err = (got.double() - want.double()).abs()
    assert bool((err <= rtol * scale).all()), float(
        (err / scale.clamp_min(1e-300)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("m,p", HISTORY_SHAPES,
                         ids=[f"m{m}-P{p}" for m, p in HISTORY_SHAPES])
def test_history_kernels_match_plain(dev, dtype, m, p):
    """Both kernels against their plain versions at the default
    tolerance, one launch each a call, two launches bit-equal."""
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh

    SY, y, s, g, coef, gamma = _history_inputs(m, p, dtype, dev)
    before = dict(lh.launch_counts)
    dots = lh.history_dots(SY, y, s, g)
    comb = lh.history_combine(SY, g, coef, gamma, -0.5)
    torch.cuda.synchronize()
    assert lh.launch_counts["lbfgs_history_dots"] == \
        before["lbfgs_history_dots"] + 1
    assert lh.launch_counts["lbfgs_history_combine"] == \
        before["lbfgs_history_combine"] + 1
    rtol = HISTORY_RTOL[dtype]
    A = SY.abs()
    _within(dots, lh.history_dots_plain(SY, y, s, g),
            A.double() @ torch.stack([y, s, g], 1).abs().double(), rtol)
    _within(comb, lh.history_combine_plain(SY, g, coef, gamma, -0.5),
            0.5 * (gamma.abs().double() * g.abs().double()
                   + coef.abs().double() @ A.double()), rtol)
    del A
    assert torch.equal(dots, lh.history_dots(SY, y, s, g))
    assert torch.equal(comb, lh.history_combine(SY, g, coef, gamma, -0.5))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_history_kernels_take_unaligned_rows(dev, dtype):
    """A history that starts off a 16-byte boundary (a view one element
    into its buffer) and vectors likewise take the scalar variants, with
    the same result as the plain versions."""
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh

    m, p = 4, 4096
    SY0, y0, s0, g0, coef, gamma = _history_inputs(m, p + 1, dtype, dev)
    SY = SY0.reshape(-1)[1:1 + 2 * m * p].view(2 * m, p)
    y, s, g = y0[1:], s0[1:], g0[1:]
    assert SY.is_contiguous() and SY.data_ptr() % 16
    rtol = HISTORY_RTOL[dtype]
    _within(lh.history_dots(SY, y, s, g), lh.history_dots_plain(SY, y, s, g),
            SY.abs().double() @ torch.stack([y, s, g], 1).abs().double(),
            rtol)
    _within(lh.history_combine(SY, g, coef, gamma),
            lh.history_combine_plain(SY, g, coef, gamma),
            gamma.abs().double() * g.abs().double()
            + coef.abs().double() @ SY.abs().double(), rtol)


def test_history_kernels_replay_bit_equal(dev):
    """Both kernels recorded in a CUDA graph: one replay gives the eager
    call's bits (gamma and coef read on the device at replay)."""
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh

    SY, y, s, g, coef, gamma = _history_inputs(100, 81_204, torch.float32,
                                               dev)
    eager = (lh.history_dots(SY, y, s, g),
             lh.history_combine(SY, g, coef, gamma))
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):      # warm the allocator off the graph
        lh.history_dots(SY, y, s, g)
        lh.history_combine(SY, g, coef, gamma)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = (lh.history_dots(SY, y, s, g),
               lh.history_combine(SY, g, coef, gamma))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[0], eager[0]) and torch.equal(out[1], eager[1])


def test_history_wrappers_refuse_what_they_do_not_take(dev):
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh

    SY, y, s, g, coef, gamma = _history_inputs(3, 64, torch.float32, dev)
    bad = [
        lambda: lh.history_dots(SY.t().contiguous().t(), y, s, g),
        lambda: lh.history_dots(SY, y.cpu(), s, g),
        lambda: lh.history_dots(SY, y, s, torch.zeros(65, device=dev)),
        lambda: lh.history_dots(SY, y.double(), s, g),
        lambda: lh.history_dots(SY.half(), y.half(), s.half(), g.half()),
        lambda: lh.history_combine(SY.t().contiguous().t(), g, coef, gamma),
        lambda: lh.history_combine(SY, g, coef.cpu(), gamma),
        lambda: lh.history_combine(SY, g, coef[:-1], gamma),
        lambda: lh.history_combine(SY, g, coef, gamma.reshape(1)),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def _diag_quadratic(p, steps, seed):
    """(x, g) of a few noisy gradient steps on a diagonal quadratic, the
    gradient of step 3 negated (its pair then fails the curvature guard)."""
    rng = np.random.default_rng(seed)
    lam = rng.uniform(0.1, 10.0, p)
    x = rng.standard_normal(p)
    seq = []
    for i in range(steps):
        g = lam * x
        if i == 3:
            g = -g
        seq.append((x.copy(), g))
        x = x - 0.05 * g + 0.01 * rng.standard_normal(p)
    return seq


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("learning_rate", [None, 1.0])
def test_compact_lbfgs_on_the_card_matches_the_cpu(dev, dtype,
                                                   learning_rate):
    """12 updates of ``CompactLBFGS`` (m = 4: the history wraps twice,
    one pair rejected) on the card against the same updates on the CPU
    (the plain products): each step within the file's f32 gradient
    tolerance (1e-9 in float64); one launch of each kernel an update."""
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh
    from hidenn_fem_tpu_torch.solve import optimizers as topt

    seq = _diag_quadratic(4099, 12, seed=1)
    steps = {}
    for where in ("cpu", dev):
        opt = topt.CompactLBFGS(memory_size=4, learning_rate=learning_rate)
        state = opt.init(torch.tensor(seq[0][0], dtype=dtype, device=where))
        before = dict(lh.launch_counts)
        out = []
        for x, g in seq:
            step, state = opt.update(
                torch.tensor(g, dtype=dtype, device=where), state,
                torch.tensor(x, dtype=dtype, device=where))
            out.append(step.cpu())
        launched = {k: lh.launch_counts[k] - before[k] for k in before}
        assert launched == dict.fromkeys(
            before, 0 if where == "cpu" else len(seq))
        steps[str(where)] = torch.stack(out)
    tol = (5e-4, 1e-5) if dtype == torch.float32 else (1e-9, 1e-9)
    for got, want in zip(steps[str(dev)], steps["cpu"]):
        assert torch.isfinite(got).all()
        _close(got, want, *tol)


def test_captured_lbfgs_counts_each_replay(dev):
    """A captured ``run_lbfgs`` moves the history kernels' counters by
    one launch each a step, replays included, as the eager run does."""
    from hidenn_fem_tpu_torch.ops import lbfgs_history as lh

    lat = pt.proxy_plate_mesh(nx=33, ny=17, device=dev)
    loss, params, args = _plate_case(lat, dev)
    before = dict(lh.launch_counts)
    pt.run_lbfgs(loss, params, num_steps=20, memory_size=10, loss_args=args)
    torch.cuda.synchronize()
    assert {k: lh.launch_counts[k] - before[k] for k in before} == \
        dict.fromkeys(before, 20)
