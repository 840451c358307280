"""The port's linear solvers and what they call against the JAX package:
``mesh/coloring.py``, Adam / ``adam_per_group`` / ``freeze_groups``,
``minimize``, and ``solve/linear.py`` (``cg_solve``, ``jacobi_diagonal``,
``jacobi_pcg_solve``, ``radapt_cg_solve``), from the same numpy inputs.

Tolerances:
* colorings array-equal, each path selected with ``HDNN_NO_NATIVE``:
  the numpy Jones–Plassmann rounds (same seed) to JAX's rounds, and the
  port's native pass to the JAX package's native library;
* Adam: params rtol 1e-12 (f64) and 1e-6 (f32), each with atol rtol x
  max|params| (XLA may fuse the loss's polynomial into other roundings),
  after 20 steps; frozen groups bit for bit;
* CG on JAX's SPD quadratic: solution rtol 1e-5 (f32) and 1e-10 (f64);
* CG on the 41x21 plate: f64 solution within 1e-10 x max|u|; f32 within
  1e-4 x max|u| (both f32 solutions lie ~8e-5 x max|u| from the f64
  solution at tol 1e-6, measured on the CPU, and ~2e-5 from each other),
  f32 energies rtol 1e-6; the executed history's first 20 entries rtol
  1e-3; zeros past the stop in both; Dirichlet rows exactly unchanged;
* Jacobi diagonal: rtol 1e-5 against JAX's (f32) and 5e-6 x max(|d|, 1e3)
  against a dense f64 probe, as ``tests/test_coloring_pcg.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.mesh import coloring as jcol
from hidenn_fem_tpu_torch.mesh import coloring as tcol

from torch_port_common import CPU, assert_close

F32_SOLUTION = 1e-4


def _plate(nx, ny, dtype=torch.float32):
    """The JAX package's proxy plate and the port's mesh of its arrays."""
    mesh = ht.proxy_plate_mesh(nx=nx, ny=ny)
    if dtype == torch.float64:
        jm = ht.TriMesh.from_arrays(*[np.asarray(a) for a in mesh.astuple()],
                                    dtype=jnp.float64)
    else:
        jm = mesh
    return jm, pt.mesh_from_numpy(mesh, device=CPU, dtype=dtype)


def _u_losses(tdtype=torch.float32, jdtype=jnp.float32):
    """The displacement losses (coords through loss_args) of both
    packages' plate energies, and the energies."""
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(dtype=jdtype), E=10e9,
                              nu=0.3)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=tdtype), E=10e9,
                              nu=0.3)

    def jl(p, coords, m):
        return je({"u": p["u"], "coords": coords}, m)

    def tl(p, coords, m):
        return te({"u": p["u"], "coords": coords}, m)
    return jl, tl, je, te


def _u0(n, seed=0):
    return 1e-5 * np.random.default_rng(seed).standard_normal((n, 2))


# ---------------------------------------------------------------- coloring
@pytest.mark.parametrize("path", ["numpy", "native"])
@pytest.mark.parametrize("which", ["plate21x11", "plate41x21", "delaunay"])
def test_coloring_matches_jax(which, path, monkeypatch):
    """``color_nodes`` on each path equals the JAX package's same path:
    the numpy rounds (``HDNN_NO_NATIVE=1``) JAX's rounds, the native pass
    (the port's library built here, the JAX package's by
    ``tests/conftest.py``) JAX's native colors."""
    from hidenn_fem_tpu.mesh import native as jnative
    from hidenn_fem_tpu_torch.mesh import native as tnative

    if path == "numpy":
        monkeypatch.setenv("HDNN_NO_NATIVE", "1")
        assert not tnative.available()
    else:
        monkeypatch.delenv("HDNN_NO_NATIVE", raising=False)
        tnative.build(verbose=False)
        assert tnative.available() and jnative.available()
    if which == "delaunay":
        from hidenn_fem_tpu.mesh.delaunay import generate_mesh_delaunay
        mesh = generate_mesh_delaunay(lc=0.09)
    else:
        nx, ny = (21, 11) if which == "plate21x11" else (41, 21)
        mesh = ht.proxy_plate_mesh(nx=nx, ny=ny)
    conn = np.asarray(mesh.connectivity)
    want = (jcol._greedy_color_numpy(conn, mesh.n_nodes) if path == "numpy"
            else jnative.greedy_color(conn, mesh.n_nodes))
    got = tcol.color_nodes(torch.tensor(conn), mesh.n_nodes)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32
    assert tcol.check_coloring(torch.tensor(conn), got)
    assert got.max() + 1 <= 8


def test_check_coloring_rejects_a_bad_coloring():
    mesh = ht.proxy_plate_mesh(nx=21, ny=11)
    conn = np.asarray(mesh.connectivity)
    colors = tcol.color_nodes(conn, mesh.n_nodes)
    bad = colors.copy()
    a, b = conn[7, 0], conn[7, 1]
    bad[b] = bad[a]
    assert not tcol.check_coloring(conn, bad)
    assert not jcol.check_coloring(conn, bad)
    assert tcol.check_coloring(conn, colors)


# -------------------------------------------------------------- optimizers
def _toy_loss(p, a, sum_):
    """A separable polynomial (no transcendental, so both packages'
    gradients agree bit for bit and only the optimizers differ)."""
    c = p["coords"]
    return sum_(a * p["u"] ** 2) + sum_(c * c * c * c - a * c)


def _toy_loss_jax(p, a):
    return _toy_loss(p, a, jnp.sum)


def _toy_loss_torch(p, a):
    return _toy_loss(p, a, torch.sum)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
@pytest.mark.parametrize("which", ["adam", "adam_per_group", "freeze"])
def test_adam_family_matches_optax(which, dtype):
    rng = np.random.default_rng(3)
    p_np = {"coords": rng.standard_normal((6, 2)),
            "u": rng.standard_normal((6, 2))}
    a_np = rng.uniform(0.5, 2.0, (6, 2))
    f64 = dtype == "f64"
    tdt = torch.float64 if f64 else torch.float32
    make = {"adam": lambda m: m.adam(0.05),
            "adam_per_group": lambda m: m.adam_per_group(
                {"u": 0.05, "coords": 0.01}),
            "freeze": lambda m: m.freeze_groups(m.adam(0.05), ["u"])}[which]
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        jp = {k: jnp.asarray(v, jdt) for k, v in p_np.items()}
        jopt = make(ht)
        jsol, jl = ht.run_optimizer(_toy_loss_jax, jp, jopt, 20,
                                    (jnp.asarray(a_np, jdt),))
        jsol = {k: np.asarray(v) for k, v in jsol.items()}
        jl = np.asarray(jl)
    tp = pt.params_from_numpy(p_np, device=CPU, dtype=tdt)
    tsol, tl = pt.run_optimizer(_toy_loss_torch, tp, make(pt), 20,
                                (torch.tensor(a_np, dtype=tdt),))
    rtol = 1e-12 if f64 else 1e-6
    for k in p_np:
        assert_close(tsol[k].numpy(), jsol[k], rtol=rtol,
                     atol=rtol * np.abs(jsol[k]).max(), what=k)
    assert_close(tl.numpy(), jl, rtol=rtol)
    if which == "freeze":
        assert torch.equal(tsol["u"], tp["u"])
        assert not torch.equal(tsol["coords"], tp["coords"])


def test_group_adam_needs_every_group():
    tp = pt.params_from_numpy({"coords": np.zeros((2, 2)),
                               "u": np.zeros((2, 2))}, device=CPU)
    with pytest.raises(KeyError, match="coords"):
        pt.run_optimizer(_toy_loss_torch, tp, pt.adam_per_group({"u": 1.0}),
                         1, (torch.ones(2, 2),))


# ----------------------------------------------------------------- minimize
@pytest.mark.parametrize("method", ["adam", "lbfgs", "cg", "jacobi_cg"])
def test_minimize_matches_jax(method):
    """Each method of the front end on the 21x11 plate, in f64 (the
    fixed-step L-BFGS amplifies f32 rounding from its first step on):
    loss histories and solutions rtol 1e-8.  The CG methods solve to tol
    1e-10; their residual histories agree to 1e-14 for ~45 iterations
    and then part (rounding grows exponentially once the Krylov vectors
    lose orthogonality, in either package; measured on the CPU), so the
    first 40 entries are held at rtol 1e-8 and the solutions at 1e-8 x
    max|u|."""
    kw = {"adam": dict(num_steps=30, group_lrs={"u": 1e-6}),
          "lbfgs": dict(num_steps=30),
          "cg": dict(num_steps=600, tol=1e-10),
          "jacobi_cg": dict(num_steps=600, tol=1e-10)}[method]
    jkw, tkw = dict(kw), dict(kw)
    with jax.enable_x64(True):
        jm, tm = _plate(21, 11, torch.float64)
        jl, tl, _, _ = _u_losses(torch.float64, jnp.float64)
        u0 = _u0(jm.n_nodes, 1)
        if method == "jacobi_cg":
            jkw["mesh"], tkw["mesh"] = jm, tm
        jr = ht.minimize(jl, {"u": jnp.asarray(u0)}, method=method,
                         loss_args=(jm.coords, jm), **jkw)
        jh, ju = np.asarray(jr.history), np.asarray(jr.params["u"])
    tr = pt.minimize(tl, {"u": torch.tensor(u0)}, method=method,
                     loss_args=(tm.coords, tm), **tkw)
    kind = "relres" if method in ("cg", "jacobi_cg") else "loss"
    assert jr.kind == tr.kind == kind
    assert isinstance(tr, pt.MinimizeResult) and len(tr) == 2
    params, history = tr
    assert params is tr.params and history is tr.history
    th = tr.history.numpy()
    assert th.shape == jh.shape
    n = 40 if kind == "relres" else len(jh)
    assert_close(th[:n], jh[:n], rtol=1e-8, what="history")
    assert_close(tr.params["u"].numpy(), ju, rtol=1e-8,
                 atol=1e-8 * np.abs(ju).max(), what="u")


def test_minimize_rejects_an_unknown_method():
    with pytest.raises(ValueError, match="unknown method 'newton'") as tj:
        ht.minimize(lambda p: 0.0, {}, method="newton")
    with pytest.raises(ValueError, match="unknown method 'newton'") as tt:
        pt.minimize(lambda p: 0.0, {}, method="newton")
    assert str(tt.value) == str(tj.value)


# ----------------------------------------------------------------------- CG
def _spd(n, seed=0):
    rng = np.random.RandomState(seed)
    A = rng.randn(n, n)
    K = A @ A.T + n * np.eye(n)
    return K, rng.randn(n)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cg_on_spd_quadratic_matches_jax(dtype):
    """``tests/test_cg_solve.py``'s SPD quadratic, in both precisions."""
    n = 24
    K, f = _spd(n)
    if dtype == "f32":
        K, f = K.astype(np.float32), f.astype(np.float32)
    f64 = dtype == "f64"
    tol, rtol = (1e-12, 1e-10) if f64 else (1e-7, 1e-5)
    with jax.enable_x64(f64):
        Kj, fj = jnp.asarray(K), jnp.asarray(f)
        jsol, jh = ht.cg_solve(
            lambda p, K, f: 0.5 * p["x"] @ K @ p["x"] - f @ p["x"],
            {"x": jnp.zeros(n, Kj.dtype)}, (Kj, fj), max_iters=2 * n,
            tol=tol)
        jx, jh = np.asarray(jsol["x"]), np.asarray(jh)
    Kt, ft = torch.tensor(K), torch.tensor(f)
    tsol, th = pt.cg_solve(
        lambda p, K, f: 0.5 * p["x"] @ K @ p["x"] - f @ p["x"],
        {"x": torch.zeros(n, dtype=Kt.dtype)}, (Kt, ft), max_iters=2 * n,
        tol=tol)
    assert th.dtype == Kt.dtype and th.shape == (2 * n,)
    assert_close(tsol["x"].numpy(), jx, rtol=rtol,
                 atol=rtol * np.abs(jx).max())
    assert_close(tsol["x"].numpy(), np.linalg.solve(K.astype(np.float64),
                                                    f.astype(np.float64)),
                 rtol=20 * rtol, atol=20 * rtol * np.abs(jx).max())
    th = th.numpy()
    k, kj = int((th > 0).sum()), int((jh > 0).sum())
    assert np.all(th[:k] > 0) and np.all(th[k:] == 0) and k < 2 * n
    assert_close(th[:min(k, kj, 10)], jh[:min(k, kj, 10)], rtol=1e-3)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_cg_on_plate_matches_jax(dtype):
    f64 = dtype == "f64"
    tdt = torch.float64 if f64 else torch.float32
    tol = 1e-10 if f64 else 1e-6
    with jax.enable_x64(f64):
        jdt = jnp.float64 if f64 else jnp.float32
        jm, tm = _plate(41, 21, tdt)
        jl, tl, _, _ = _u_losses(tdt, jdt)
        u0 = _u0(jm.n_nodes)
        jsol, jh = ht.cg_solve(jl, {"u": jnp.asarray(u0, jdt)},
                               (jm.coords, jm), max_iters=1500, tol=tol)
        ju, jh = np.asarray(jsol["u"]), np.asarray(jh)
        je = float(jl(jsol, jm.coords, jm))
    tsol, th = pt.cg_solve(tl, {"u": torch.tensor(u0, dtype=tdt)},
                           (tm.coords, tm), max_iters=1500, tol=tol)
    tu, th = tsol["u"].numpy(), th.numpy()
    scale = np.abs(ju).max()
    assert_close(tu, ju, rtol=0, atol=(1e-10 if f64 else F32_SOLUTION)
                 * scale, what="solution")
    with torch.no_grad():
        te = float(tl(tsol, tm.coords, tm))
    assert_close(te, je, rtol=1e-10 if f64 else 1e-6, what="energy")
    k, kj = int((th > 0).sum()), int((jh > 0).sum())
    assert 0 < k < 1500 and 0 < kj < 1500
    assert np.all(th[k:] == 0) and np.all(jh[kj:] == 0)
    assert th[k - 1] <= tol and jh[kj - 1] <= tol
    assert_close(th[:20], jh[:20], rtol=1e-3, what="history")
    # Dirichlet rows never move
    fixed = tm.dirichlet_mask.numpy()
    assert np.array_equal(tu[fixed], u0.astype(tu.dtype)[fixed])


def test_jacobi_diagonal_matches_jax_and_dense():
    jm, tm = _plate(13, 7)
    jl, tl, _, _ = _u_losses()
    u0 = _u0(jm.n_nodes)
    colors = tcol.color_nodes(tm.connectivity, tm.n_nodes)
    jd = np.asarray(ht.jacobi_diagonal(
        jl, {"u": jnp.asarray(u0, jnp.float32)}, (jm.coords, jm),
        colors)["u"])
    td = pt.jacobi_diagonal(tl, {"u": torch.tensor(u0, dtype=torch.float32)},
                            (tm.coords, tm), torch.tensor(colors))["u"]
    assert_close(td.numpy(), jd, rtol=1e-5, atol=1e-5 * np.abs(jd).max())
    fixed = tm.dirichlet_mask.numpy()
    assert np.all(td.numpy()[fixed] == 0.0)
    # against a dense f64 probe, one DOF at a time
    with jax.enable_x64(True):
        _, tm64 = _plate(13, 7, torch.float64)
    _, tl64, _, _ = _u_losses(torch.float64)
    u = torch.tensor(u0, dtype=torch.float64)

    def g(v):
        v = v.clone().requires_grad_(True)
        (gv,) = torch.autograd.grad(tl64({"u": v}, tm64.coords, tm64), v)
        return gv
    g0 = g(u)
    n = tm.n_nodes
    for i in range(0, n, 5):
        for k in range(2):
            z = torch.zeros((n, 2), dtype=torch.float64)
            z[i, k] = 1.0
            ref = float((g(u + z) - g0)[i, k])
            assert abs(float(td[i, k]) - ref) <= 5e-6 * max(abs(ref), 1e3)


def _graded(coords):
    c = np.asarray(coords, dtype=np.float64).copy()
    L, H = 2.0, 1.0
    c[:, 0] = L * (c[:, 0] / L) ** 3 * 0.999 + c[:, 0] * 0.001
    c[:, 1] = H * (c[:, 1] / H) ** 2 * 0.999 + c[:, 1] * 0.001
    return c


def test_jacobi_pcg_on_graded_plate_matches_jax():
    """``tests/test_coloring_pcg.py``'s graded plate: the port's Jacobi
    PCG residual well under plain CG's at matched iteration counts (f32,
    41x21, as there), and its solution against JAX's in f64 (21x11, the
    same grading; in f32 both stall
    at the float32 floor of this ill-conditioned system, where their
    solutions are noise), within 1e-7 x max|u| (the graded system is
    ill-conditioned: at relres 1e-10 the two f64 solutions part by
    1.5e-8 x max|u|, measured on the CPU)."""
    _, tm = _plate(41, 21)
    _, tl, _, _ = _u_losses()
    u0 = _u0(tm.n_nodes)
    graded = _graded(tm.coords.numpy())
    tg = torch.tensor(graded, dtype=torch.float32)
    tu = {"u": torch.tensor(u0, dtype=torch.float32)}
    _, th = pt.jacobi_pcg_solve(tl, tu, (tg, tm), mesh=tm, max_iters=100,
                                tol=1e-12)
    _, thc = pt.cg_solve(tl, tu, (tg, tm), max_iters=100, tol=1e-12)
    th, thc = th.numpy(), thc.numpy()
    assert th[99] * 5 < thc[99], (th[99], thc[99])

    with jax.enable_x64(True):
        jm, tm = _plate(21, 11, torch.float64)
        jl, tl, _, _ = _u_losses(torch.float64, jnp.float64)
        u0 = _u0(tm.n_nodes)
        graded = _graded(tm.coords.numpy())
        jsol, jh = ht.jacobi_pcg_solve(
            jl, {"u": jnp.asarray(u0)}, (jnp.asarray(graded), jm), mesh=jm,
            max_iters=1000, tol=1e-10)
        ju, jh = np.asarray(jsol["u"]), np.asarray(jh)
    tsol, th = pt.jacobi_pcg_solve(tl, {"u": torch.tensor(u0)},
                                   (torch.tensor(graded), tm), mesh=tm,
                                   max_iters=1000, tol=1e-10)
    th = th.numpy()
    assert th[th > 0][-1] <= 1e-10 and jh[jh > 0][-1] <= 1e-10
    assert_close(tsol["u"].numpy(), ju, rtol=0,
                 atol=1e-7 * np.abs(ju).max(), what="solution")
    assert_close(th[:20], jh[:20], rtol=1e-8, what="history")


def test_radapt_cg_matches_jax():
    """Per-epoch energies rtol 1e-5.  The coordinates are not compared:
    under a near-uniform stress the interior nodes' coordinate gradients
    are rounding noise, and Adam's scale-free step moves such a node by
    about the learning rate in the noise's direction, in either package."""
    jm, tm = _plate(21, 11)
    _, _, je, te = _u_losses()
    u0 = _u0(jm.n_nodes)
    kw = dict(outer_epochs=2, cg_iters=300, coord_steps=5, coord_lr=1e-5)
    jp, jen = ht.radapt_cg_solve(
        lambda p, m: je(p, m),
        {"u": jnp.asarray(u0, jnp.float32), "coords": jm.coords},
        loss_args=(jm,), **kw)
    tp, ten = pt.radapt_cg_solve(
        lambda p, m: te(p, m),
        {"u": torch.tensor(u0, dtype=torch.float32), "coords": tm.coords},
        loss_args=(tm,), **kw)
    assert ten.shape == (2,)
    assert_close(ten.numpy(), np.asarray(jen), rtol=1e-5, what="energies")
    assert float(ten[1]) < float(ten[0])
    assert float((tp["coords"] - tm.coords).abs().max()) > 0


def test_example8_small():
    from examples import example8_linear_solve_torch as ex8

    params, energies, hist, e_cg = ex8.main(nx=21, ny=11, max_iters=300,
                                            radapt_epochs=2, device="cpu")
    h = hist.numpy()
    assert h[h > 0][-1] <= 1e-6
    assert energies.shape == (2,) and np.all(np.isfinite(energies))
    assert abs(energies[0] - e_cg) <= 1e-6 * abs(e_cg)
    assert energies[-1] <= energies[0] + 1e-6 * abs(energies[0])
