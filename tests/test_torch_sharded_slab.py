"""The lattice stencil kernels over row windows, and the row-sharded slab
energy (``hidenn_fem_tpu_torch/parallel/sharded_slab.py``), against the
JAX package.

In this process: the plain versions of K6/K7 over a row window
(``lattice_stencil_{vg,fwd}_rows_plain``) against JAX's ``_pallas_vg``
with ``row0`` in interpret mode, on 37x53 and 65x17 lattices (up, down, a
sel mask, the zigzag parity; with and without presence masks; 1-4
windows, the JAX package's per-device row blocks, ragged or empty at the
end), on windows of 1, 4 and 6 rows (at row_lo = 0 and at row_hi = nx),
and on the 3- and 4-rank windows of a multigrid level padded with DEAD
rows.  Each window's gradient rows: rtol 1e-5 + 1e-5 x max|g|; the sum of
the window energies: rtol 1e-5 (the two packages own the quads on a
window's seam differently: the port by the quad's first row, JAX by its
second; only the sum is held to JAX).  K6's and K7's plain window
energies are the same function.

Spawned gloo groups of 3 and 4 CPU ranks (``tests/torch_sharded_common``)
run ``shard_map_lattice_slab`` on 65x17 lattices (up, zigzag, holes with
dead nodes kept: ragged windows for both rank counts) with a 10-step
sharded ``run_lbfgs`` on the holes plate, every rank's values bit-equal
to rank 0's, against JAX's ``shard_map_lattice_slab`` over
``jax.devices("cpu")[:4]`` (f32 only, as in JAX: energy rtol 1e-5,
gradients atol 1e-5 x max|g|, loss history rtol 5e-3, the f32 spread of
10 fixed steps); a renumbered mesh raises in both.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh.structured import generate_mesh
from hidenn_fem_tpu.ops import lattice_slab as jls
from hidenn_fem_tpu.parallel.sharded_slab import (_device_grid,
                                                  shard_map_lattice_slab)
from hidenn_fem_tpu.parallel.sharding import ELEM_AXIS
from hidenn_fem_tpu_torch.ops import lattice_slab as pls
from hidenn_fem_tpu_torch.parallel import device_mesh
from hidenn_fem_tpu_torch.parallel import sharded_slab as pss

from torch_port_common import CPU, assert_close, random_params
from torch_sharded_common import Groups, mesh_arrays

E, NU, W_SUM = 10e9, 0.3, 0.5
F32_HISTORY_RTOL = 5e-3


# Narrow windows (1, 4 and 6 node rows, as the sharded multigrid's 4-6 row
# windows of padded levels), a partition of a 37-row lattice that starts
# and ends with a 1-row window: row_lo = 0 and row_hi = nx included.
NARROW = (0, 1, 5, 11, 12, 18, 22, 28, 32, 36, 37)


def _window_cases():
    """Every diagonal with and without masks, and 1-4 windows of the JAX
    package's per-device row blocks on each lattice; narrow windows
    (NARROW) on two lattices; the windows of a padded multigrid level
    (DEAD rows, the zigzag parity moved by the padding) for 3 and 4 ranks
    ("mg3", "mg4")."""
    out = []
    for shape, first_masked in (((37, 53), False), ((65, 17), True)):
        for i, diag in enumerate(("up", "down", "sel", "zigzag")):
            masked = first_masked == (i % 3 == 0)
            n_windows = 1 + i if first_masked is False else 4 - i
            out.append((shape, diag, masked, n_windows))
    out += [((37, 53), "zigzag", True, NARROW),
            ((37, 21), "up", False, NARROW),
            ((33, 29), "sel", True, 2),
            ((29, 37), "down", False, 3),
            ((17, 9), "zigzag", True, "mg3"),
            ((17, 9), "zigzag", True, "mg4")]
    return out


def _lattice_inputs(nx, ny, diag, masked, seed):
    """A perturbed lattice's [nx*ny, 4] node table and its stencil masks
    (numpy): a sel mask for "sel", the parity for "zigzag", t1/t2 with
    about a fifth of the triangles absent when ``masked``."""
    rng = np.random.default_rng(seed)
    x, y = np.meshgrid(np.linspace(0, 2, nx), np.linspace(0, 1, ny),
                       indexing="ij")
    node = np.stack([x, y, np.zeros_like(x), np.zeros_like(x)], -1)
    node[..., :2] += 0.1 * (2.0 / nx) * rng.standard_normal((nx, ny, 2))
    node[..., 2:] = 1e-4 * rng.standard_normal((nx, ny, 2))
    q = (nx - 1, ny - 1)
    sel = None
    if diag == "sel":
        sel = (rng.random(q) < 0.5).astype(np.float32)
    elif diag == "zigzag":
        ii, jj = np.meshgrid(np.arange(q[0]), np.arange(q[1]), indexing="ij")
        sel = ((ii + jj) % 2 == 0).astype(np.float32)
    t1 = t2 = None
    if masked:
        t1 = (rng.random(q) > 0.2).astype(np.float32)
        t2 = (rng.random(q) > 0.2).astype(np.float32)
    return node.reshape(nx * ny, 4).astype(np.float32), sel, t1, t2


def _padded_level(nx, ny, ranks):
    """A zigzag multigrid level with a hole, padded with DEAD rows for
    ``ranks`` ranks as the sharded multigrid pads it
    (``parallel/sharded_mg.py``): (node table, padded rows, sel = the
    parity moved by the padding, t1 = t2 = the quad mask; numpy) and the
    parity's phase."""
    from hidenn_fem_tpu_torch.models.structured_grid import (
        StructuredGridP1, generate_structured_grid)
    from hidenn_fem_tpu_torch.parallel import sharded_mg

    grid = generate_structured_grid(nx=nx, ny=ny, split="zigzag",
                                    holes=((1.0, 0.5, 0.3),), device=CPU)
    model = StructuredGridP1(E=E, nu=NU)
    params = model.init(np.random.default_rng(0), grid, device=CPU)
    coords = model.coords(params, grid).detach()
    gP, cP, uP, k = sharded_mg._pad(grid, coords, params["u"], ranks)
    assert k != 0 and gP.nx % ranks == 0
    node = torch.cat([model.coords({"coords": cP}, gP),
                      model.u_full({"u": uP}, gP)], dim=-1)
    ii, jj = np.meshgrid(np.arange(gP.nx - 1), np.arange(gP.ny - 1),
                         indexing="ij")
    sel = ((ii + jj + gP.zigzag_phase) % 2 == 0).astype(np.float32)
    qm = gP.quad_mask.numpy().astype(np.float32)
    assert not qm[-1].any() or not qm[0].any()    # a DEAD quad row
    return (node.reshape(-1, 4).detach().numpy().astype(np.float32),
            gP.nx, sel, qm, qm.copy()), gP.zigzag_phase


@pytest.mark.parametrize("shape,diag,masked,windows", _window_cases(),
                         ids=lambda v: ("narrow" if v == NARROW else None))
def test_row_windows_plain_match_jax_interpret(shape, diag, masked,
                                               windows):
    nx, ny = shape
    phase = 0
    if isinstance(windows, str):                 # a padded level
        ranks = int(windows[2:])
        (node, nx, sel, t1, t2), phase = _padded_level(nx, ny, ranks)
        spans = [(1, nx // ranks, lo, hi) for lo, hi in
                 (pss.row_window(nx, r, ranks) for r in range(ranks))]
    else:
        node, sel, t1, t2 = _lattice_inputs(nx, ny, diag, masked,
                                            seed=nx + ny)
        if isinstance(windows, int):             # JAX's device blocks
            _, nb, bi = _device_grid(nx, windows)
            spans = [(nb, bi, d * nb * bi, d * nb * bi + nb * bi)
                     for d in range(windows)]
        else:                                    # explicit windows
            spans = [(1, hi - lo, lo, hi)
                     for lo, hi in zip(windows[:-1], windows[1:])]
    sel_up = {"up": True, "down": False}.get(diag)
    all_present = not masked
    rows_tot = max(max(r0 + nb * bi for nb, bi, r0, _ in spans), nx)
    nyp = -(-ny // 128) * 128
    f = E / (1.0 - NU ** 2)
    route = types.SimpleNamespace(
        sel=None if sel is None else jnp.asarray(sel),
        t1=None if t1 is None else jnp.asarray(t1),
        t2=None if t2 is None else jnp.asarray(t2))
    packed = {}

    def jax_window(nb, bi, r0):
        """JAX's _pallas_vg and _pallas_fwd over nb blocks of bi rows from
        row r0: (energy, gradient slab, K7's energy)."""
        if (nb, bi) not in packed:
            packed[nb, bi] = (
                jls._pack(jnp.asarray(node), nx, ny, nb, bi, rows=rows_tot),
                jls._pack_masks(route, sel_up, all_present, nb, bi, nyp,
                                jnp.float32, rows=rows_tot),
                jax.jit(lambda s, m, r: jls._pallas_vg(
                    s, m, nx, ny, nb, bi, f, NU, W_SUM, sel_up,
                    all_present, True, row0=r)),
                jax.jit(lambda s, m, r: jls._pallas_fwd(
                    s, m, nx, ny, nb, bi, f, NU, W_SUM, sel_up,
                    all_present, True, row0=r)))
        slab, masks, vg, fwd = packed[nb, bi]
        return (*vg(slab, masks, jnp.int32(r0)),
                fwd(slab, masks, jnp.int32(r0)))

    kw = dict(diag={"up": pls.UP, "down": pls.DOWN, "sel": pls.SEL_MASK,
                    "zigzag": pls.PARITY}[diag],
              phase=phase, sel=None if diag != "sel" else torch.tensor(sel),
              t1=None if t1 is None else torch.tensor(t1),
              t2=None if t2 is None else torch.tensor(t2))
    node_t = torch.tensor(node)
    e_whole, g_whole = pls.lattice_stencil_vg_plain(node_t, nx, ny, E, NU,
                                                    W_SUM, **kw)
    sum_t = sum_j = sum_j7 = 0.0
    for nb, bi, r0, end in spans:
        ej, gj, ej7 = jax_window(nb, bi, r0)
        sum_j += float(ej)
        sum_j7 += float(ej7)
        lo, hi = min(r0, nx), min(end, nx)
        if lo == hi:            # the JAX package's empty last blocks
            assert float(ej) == 0.0 and float(ej7) == 0.0
            continue
        et, gt = pls.lattice_stencil_vg_rows_plain(node_t, nx, ny, E, NU,
                                                   W_SUM, lo, hi, **kw)
        e7 = pls.lattice_stencil_fwd_rows_plain(node_t, nx, ny, E, NU,
                                                W_SUM, lo, hi, **kw)
        assert float(e7) == float(et)
        sum_t += float(et)
        rows = np.asarray(gj)[:, :hi - lo, :ny].reshape(4, -1).T
        got = gt.numpy()
        assert_close(got[lo * ny:hi * ny], rows, rtol=1e-5,
                     atol=1e-5 * np.abs(rows).max(),
                     what=f"window [{lo}, {hi})")
        assert not got[:lo * ny].any() and not got[hi * ny:].any()
        np.testing.assert_array_equal(got[lo * ny:hi * ny],
                                      g_whole.numpy()[lo * ny:hi * ny])
    assert_close(sum_t, sum_j, rtol=1e-5, what="sum of window energies")
    # JAX's K7 owns a window's quads as its K6 does (by their second node
    # row, not the first): only the sums over the windows meet
    assert_close(sum_t, sum_j7, rtol=1e-5, what="sum of K7 window energies")
    assert_close(sum_t, float(e_whole), rtol=1e-5, what="whole lattice")


def test_row_window_bounds_are_checked():
    node = torch.zeros((6 * 5, 4))
    for lo, hi in ((0, 0), (3, 2), (-1, 2), (0, 7)):
        with pytest.raises(ValueError, match="row window"):
            pls.lattice_stencil_vg_rows_plain(node, 6, 5, E, NU, W_SUM, lo,
                                              hi)
    assert [pss.row_window(65, r, 4) for r in range(4)] == [
        (0, 17), (17, 34), (34, 51), (51, 65)]
    assert pss.row_window(9, 3, 4) == (9, 9)


# ------------------------------------------------------- spawned groups
HOLES = ((0.6, 0.4, 0.15),)
SLAB_CASES = (("up", dict(holes=(), variant="up")),
              ("zigzag", dict(holes=(), variant="zigzag")),
              ("holes", dict(holes=HOLES, variant="up",
                             keep_dead_nodes=True)),
              ("renumbered", dict(holes=HOLES, variant="up")))


class _Spawned:
    def __init__(self, folder):
        self.cases = {}
        for name, kw in SLAB_CASES:
            mesh = generate_mesh(nx=65, ny=17, **kw)
            case = dict(name=name, fn="slab", dtype="float32")
            if name == "holes":
                case["steps"] = 10
            self.cases[name] = (case, mesh_arrays(
                mesh, random_params(mesh, seed=2)), mesh)
        self.groups = Groups(folder, [(c, a) for c, a, _ in
                                      self.cases.values()], worlds=(3, 4))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    s = _Spawned(tmp_path_factory.mktemp("sharded_slab"))
    yield s
    s.groups.close()


def _jax_reference(case, arrays, mesh):
    energy = ht.PlaneStressEnergy(model=ht.TriangleP1(), E=E, nu=NU)
    loss_fn = shard_map_lattice_slab(
        energy, Mesh(np.array(jax.devices("cpu")[:4]), (ELEM_AXIS,)))
    params = {"coords": jnp.asarray(arrays["p_coords"], jnp.float32),
              "u": jnp.asarray(arrays["p_u"], jnp.float32)}
    v, g = jax.jit(jax.value_and_grad(loss_fn))(params, mesh)
    out = {"energy": float(v), "g_coords": np.asarray(g["coords"]),
           "g_u": np.asarray(g["u"])}
    if case.get("steps"):
        _, losses = ht.run_lbfgs(loss_fn, params, num_steps=case["steps"],
                                 loss_args=(mesh,))
        out["losses"] = np.asarray(losses)
    return out


@pytest.mark.parametrize("world", [3, 4])
@pytest.mark.parametrize("name", [n for n, _ in SLAB_CASES])
def test_sharded_slab_matches_jax(spawned, name, world):
    case, arrays, mesh = spawned.cases[name]
    got = spawned.groups.case(world, name)
    if name == "renumbered":
        assert "slab-kernel set" in str(got["error"])
        energy = ht.PlaneStressEnergy(model=ht.TriangleP1())
        loss_fn = shard_map_lattice_slab(
            energy, Mesh(np.array(jax.devices("cpu")[:4]), (ELEM_AXIS,)))
        with pytest.raises(ValueError, match="slab-kernel set"):
            loss_fn(ht.TriangleP1().init(jax.random.PRNGKey(0), mesh), mesh)
        return
    assert "error" not in got, str(got.get("error"))
    want = _jax_reference(case, arrays, mesh)
    assert_close(got["energy"], want["energy"], rtol=1e-5, what="energy")
    for k in ("g_coords", "g_u"):
        assert_close(got[k], want[k], rtol=0.0,
                     atol=1e-5 * np.abs(want[k]).max(), what=k)
    if case.get("steps"):
        assert got["losses"].shape == (case["steps"],)
        assert_close(got["losses"], want["losses"], rtol=F32_HISTORY_RTOL,
                     what="10-step loss history")


def test_sharded_slab_refuses_f64_and_body_force():
    mesh = pt.generate_mesh(nx=9, ny=5, holes=(), device=CPU)
    dm = device_mesh(device="cpu")
    params = pt.params_from_numpy(random_params(mesh), device=CPU)
    bf = pt.PlaneStressEnergy(model=pt.TriangleP1(),
                              body_force=lambda x: x)
    with pytest.raises(ValueError, match="not lattice-routable"):
        pss.shard_map_lattice_slab(bf, dm)(params, mesh)
    m64 = dataclasses.replace(mesh, coords=mesh.coords.double())
    p64 = {k: v.double() for k, v in params.items()}
    e64 = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=torch.float64))
    with pytest.raises(ValueError, match="slab-kernel set"):
        pss.shard_map_lattice_slab(e64, dm)(p64, m64)
