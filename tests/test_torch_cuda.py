"""The port's CUDA kernels on the card against their plain torch versions.

Every test here is marked ``cuda`` and skips where there is no CUDA
device.  This file imports neither JAX nor the JAX package, so it also
runs on a machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: rtol 1e-4 on energies (f32 sums in another order); rtol 5e-4
with atol 1e-5 x max|grad| on cotangents and gradients (coordinate
gradients are sums of cancelling terms; see tests/test_torch_losses.py).
"""

import numpy as np
import pytest
import torch

import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.ops import element_energy as ee

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
    mesh = pt.generate_mesh(nx=41, ny=21, keep_dead_nodes=True, device=dev)
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
