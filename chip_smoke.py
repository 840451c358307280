#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hidenn_fem_tpu_torch``) on one CUDA
card, the quickest proof that the port still starts on the GPU.

Run from the repository root:  ``python3 chip_smoke.py``

Phases (each raises on failure, and the script then exits non-zero):

1. Environment: CUDA is required; prints the card's name and power limit
   and checks that TF32 is off.
2. Build: compiles every ``hidenn_fem_tpu_torch/csrc/*.cu`` for sm_90a,
   one nvcc each, in parallel (into ``hidenn_fem_tpu_torch/csrc/build/``).
3. Kernel vs plain at full size, timed in turns plain, kernel, kernel,
   plain:
   a. the gather route on the 922K-class plate
      (``generate_mesh(nx=961, ny=481, keep_dead_nodes=True)``, three
      reference holes: 852,676 elements; lattice stripped): K1, K2 and
      ``incidence_sum`` against their plain versions, and the energy with
      both gradient groups on the kernel path against the plain path;
   b. the lattice route on the same plate (zigzag; sel, t1 and t2 all in
      use): K6 and K7 against their plain versions, and the lattice-route
      energy and both gradient groups on the kernel path against the
      plain path;
   c. the hole-free 961x481 "up" ``StructuredGridP1`` (uniform diagonal,
      ``quad_mask`` as presence): K6 and K7 against their plain versions.
4. Example 4 on its default route, the lattice route: 600 ``run_lbfgs``
   steps from u0 = 1e-5 N(0,1) (``np.random.default_rng(0)``), K6 on
   every step; the final energy against the JAX package's lattice-route
   value for the same init; then the energy under ``torch.no_grad()``
   (K7), held to the solve's last loss.
5. Example 4 on the gather route (lattice stripped), 600 steps, K1, K2
   and ``incidence_sum``; final energy against the JAX gather-route value.
6. Example 6 (``examples/example6_structured_torch.py``): the 1000x500
   structured plate with holes, 600 L-BFGS steps (history 10) on K6; the
   energy must fall and the von Mises stress be finite and positive; the
   energy at step 25 against the JAX package's (the 600-step value
   against the spread of the reference runs; see ``EX6_COMPARE_STEP``).
7. Scale: 50 L-BFGS steps on the 922K-class plate, lattice route (K6).

Each path of phases 4-7 runs with every launch count set to 0 just before
it and read just after, and fails if a kernel of that path did not
launch.  The last three lines of standard output are the kernels' JSON,
the ``nvidia-smi`` name and power limit, and ``{"ok": true, ...}``.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# Final energies of example 4 in the JAX package (f32, CPU) after 600
# L-BFGS steps from the init above, made with
#   JAX_PLATFORMS=cpu python -c "
#   import dataclasses, numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   from hidenn_fem_tpu.config import PlateConfig
#   c = PlateConfig()
#   m = ht.generate_mesh(c.length, c.height, list(c.holes),
#       c.make_boundaries(), c.nx, c.ny, keep_dead_nodes=True)
#   m = dataclasses.replace(m, lattice=None)   # gather route only
#   u0 = 1e-5 * np.random.default_rng(0).standard_normal((m.n_nodes, 2))
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1())
#   _, l = ht.run_lbfgs(e.total, {'coords': m.coords,
#       'u': jnp.asarray(u0, jnp.float32)}, num_steps=600, loss_args=(m,))
#   print(float(l[-1]))"
# the lattice route (the JAX package's default) without the replace line,
# the gather route with it.
JAX_EX4_LATTICE_FINAL_ENERGY = -1.3143489360809326
JAX_EX4_FINAL_ENERGY = -1.3143504858016968
EX4_RTOL = 2e-3

# Example 6 in the JAX package on the CPU: StructuredGridP1(E=10e9, nu=0.3,
# F_total=100e3, dtype=<f32 or f64>) on generate_structured_grid(holes=
# <the three reference holes>, nx=1000, ny=500), run_lbfgs(model.total,
# {"coords": grid.coords, "u": u0}, num_steps=600, memory_size=10,
# loss_args=(grid,)) with u0 = 1e-5 N(0,1) of shape [1000, 500, 2] from
# np.random.default_rng(0); entries of the loss history.  At 600 steps the
# solve is far from converged and the fixed-step L-BFGS amplifies
# rounding: JAX f32 -0.297194, JAX f64 -0.291068, and the port on the CPU
# -0.292732 (f32) and -0.289454 (f64) after 600 steps, while all four agree
# within 3e-4 at step 25.  So the rtol-2e-3 check is made at step 25
# against JAX f32, and the 600-step value is held to JAX f64 within the
# 2.6% spread of those four runs (rtol 5e-2).
EX6_COMPARE_STEP = 25
JAX_EX6_F32_AT_STEP = 34.600921630859375
JAX_EX6_F64_AT_STEP = 34.60655657313985
EX6_RTOL = 2e-3
JAX_EX6_F64_FINAL = -0.2910684935454196
EX6_FINAL_RTOL = 5e-2

# kernel vs plain tolerances at full size (f32 on both sides, sums and
# products in other orders): energy rtol 1e-4; gradients rtol 5e-4 with
# atol GRAD_ATOL x max|grad| per group.  Coordinate gradients are sums of
# cancelling terms whose f32 value lies ~4e-6 x max|grad| from an f64
# reference in either implementation (tests/test_torch_losses.py), hence
# 1e-5 rather than 1e-6.
ENERGY_RTOL = 1e-4
GRAD_RTOL = 5e-4
GRAD_ATOL = 1e-5


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of fn() in ms (CUDA events, after a warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def ab_ms(kernel_fn, plain_fn):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn)
    k1 = cuda_ms(kernel_fn)
    k2 = cuda_ms(kernel_fn)
    p2 = cuda_ms(plain_fn)
    return (k1 + k2) / 2, (p1 + p2) / 2


def check_close(name, got, want, rtol, atol_scale):
    """|got - want| <= rtol |want| + atol_scale max|want|; returns the
    max abs error."""
    got = got.detach().double()
    want = want.detach().double()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bound = rtol * want.abs() + atol_scale * want.abs().max()
    worst = float((err / bound.clamp_min(1e-300)).max())
    log(f"  {name}: max_abs_err={float(err.max()):.6g} "
        f"max|ref|={float(want.abs().max()):.6g} "
        f"worst err/bound={worst:.4g}")
    if worst > 1.0:
        raise AssertionError(f"{name}: kernel and plain disagree "
                             f"(err/bound {worst:.4g})")
    return float(err.max())


def value_and_grads(energy, params, mesh):
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    v = energy.total(p, mesh)
    gc, gu = torch.autograd.grad(v, [p["coords"], p["u"]])
    return v.detach(), gc, gu


class Counts:
    """The launch counters of every kernel module, read and reset as one."""

    def __init__(self, *modules):
        self.modules = modules

    def reset(self):
        for m in self.modules:
            m.reset_launch_counts()

    def read(self):
        out = {}
        for m in self.modules:
            out.update(m.launch_counts)
        return out


def run_path(counts, name, needs, fn):
    """Drive one path with every count at 0 just before and read just
    after; fails unless each kernel of ``needs`` launched."""
    torch.cuda.synchronize()
    counts.reset()
    result = fn()
    torch.cuda.synchronize()
    launches = counts.read()
    log(f"  launches in the {name} path: {launches}")
    for k in needs:
        if launches[k] == 0:
            raise AssertionError(f"{k} was not launched by the {name} path")
    return result, launches


def plate_922k(ht, dev):
    from hidenn_fem_tpu_torch.mesh.lattice import detect_lattice

    t0 = time.perf_counter()
    mesh = ht.generate_mesh(nx=961, ny=481, keep_dead_nodes=True,
                            device=dev)
    build_s = time.perf_counter() - t0
    arrays = [a.cpu().numpy() for a in (mesh.coords, mesh.connectivity,
                                        mesh.neumann_edges)]
    t0 = time.perf_counter()
    route = detect_lattice(*arrays)
    detect_s = time.perf_counter() - t0
    log(f"  922K-class plate: {mesh.n_nodes} nodes, {mesh.n_elements} "
        f"elements, {mesh.n_neumann_edges} Neumann edges, incidence "
        f"{tuple(mesh.incidence.shape)} ({build_s:.2f} s on the host, of "
        f"which detect_lattice {detect_s:.2f} s)")
    if mesh.n_elements != 852_676:
        raise AssertionError(f"expected 852676 elements, got "
                             f"{mesh.n_elements}")
    lat = mesh.lattice
    if not (lat is not None and route is not None and lat.identity
            and lat.uniform_sel == "" and not lat.all_present):
        raise AssertionError("the 922K-class plate must carry an identity "
                             "zigzag lattice route with holes")
    return mesh


def perturbed_params(ht, mesh, dev):
    rng = np.random.default_rng(0)
    n = mesh.n_nodes
    coords = mesh.coords.cpu().numpy().astype(np.float64)
    return ht.params_from_numpy(
        {"coords": coords + 1e-3 * rng.standard_normal((n, 2)),
         "u": 1e-4 * rng.standard_normal((n, 2))}, device=dev)


def phase_gather(ht, ee, mesh922, dev, card):
    """Phase 3a: K1, K2, incidence_sum and the gather-route energy."""
    from hidenn_fem_tpu_torch.ops.assembly import (assemble_node_grad,
                                                   flat_gather)

    mesh = dataclasses.replace(mesh922, lattice=None)
    params = perturbed_params(ht, mesh, dev)
    model = ht.TriangleP1()
    E, nu, w_sum = 10e9, 0.3, 0.5
    n = mesh.n_nodes
    node = model.packed_nodes(params, mesh).contiguous()
    conn = mesh.connectivity

    g = flat_gather(node, conn)
    k1 = ee.element_energy_fwd(node, conn, E, nu, w_sum)
    p1 = ee.element_energy_plain(g, E, nu, w_sum)
    err1 = check_close("K1 element_energy_fwd vs plain", k1, p1,
                       ENERGY_RTOL, 0.0)
    ct = torch.tensor(1.0, device=dev)
    k2 = ee.element_energy_bwd(node, conn, ct, E, nu, w_sum)
    p2 = ee.element_cotangent_plain(g, ct, E, nu, w_sum)
    err2 = check_close("K2 element_energy_bwd vs plain", k2, p2,
                       GRAD_RTOL, GRAD_ATOL)
    ga = g.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(ee.element_energy_plain(ga, E, nu,
                                                           w_sum), ga)
    check_close("K2 element_energy_bwd vs autograd(plain)", k2, auto,
                GRAD_RTOL, GRAD_ATOL)
    inc = mesh.incidence
    k3 = ee.incidence_sum(k2, inc)
    p3 = assemble_node_grad(k2, conn, inc, n)
    err3 = check_close("incidence_sum vs plain gather-sum", k3, p3,
                       GRAD_RTOL, GRAD_ATOL)
    fconn = mesh.fused_connectivity
    fg = flat_gather(node, fconn)
    ne, tw = mesh.n_elements, -100e3
    check_close("K1 fused edges vs plain",
                ee.element_energy_fwd(node, fconn, E, nu, w_sum, ne, tw),
                ee.element_energy_plain(fg, E, nu, w_sum, ne, tw),
                ENERGY_RTOL, 0.0)
    check_close("K2 fused edges vs plain",
                ee.element_energy_bwd(node, fconn, ct, E, nu, w_sum, ne, tw),
                ee.element_cotangent_plain(fg, ct, E, nu, w_sum, ne, tw),
                GRAD_RTOL, GRAD_ATOL)
    torch.cuda.synchronize()

    ms1, pms1 = ab_ms(
        lambda: ee.element_energy_fwd(node, conn, E, nu, w_sum),
        lambda: ee.element_energy_plain(flat_gather(node, conn), E, nu,
                                        w_sum))
    ms2, pms2 = ab_ms(
        lambda: ee.element_energy_bwd(node, conn, ct, E, nu, w_sum),
        lambda: ee.element_cotangent_plain(flat_gather(node, conn), ct, E,
                                           nu, w_sum))
    ms3, pms3 = ab_ms(lambda: ee.incidence_sum(k2, inc),
                      lambda: assemble_node_grad(k2, conn, inc, n))
    log(f"  K1 fwd at {mesh.n_elements} elements: kernel {ms1:.4f} ms, "
        f"plain (gather + energy) {pms1:.4f} ms [{card}]")
    log(f"  K2 bwd at {mesh.n_elements} elements: kernel {ms2:.4f} ms, "
        f"plain (gather + cotangent) {pms2:.4f} ms [{card}]")
    log(f"  incidence_sum at {n} nodes x {inc.shape[1]} slots: kernel "
        f"{ms3:.4f} ms, plain (pad + gather + sum) {pms3:.4f} ms [{card}]")

    for fuse in (False, True):
        ek = ht.PlaneStressEnergy(model=model, backend="kernel",
                                  fuse_edges=fuse)
        ep = ht.PlaneStressEnergy(model=model, backend="plain",
                                  fuse_edges=fuse)
        before = dict(ee.launch_counts)
        vk, gck, guk = value_and_grads(ek, params, mesh)
        grew = {k: ee.launch_counts[k] - before[k] for k in before}
        if min(grew.values()) < 1:
            raise AssertionError(f"gather-route kernel path launched {grew}")
        vp, gcp, gup = value_and_grads(ep, params, mesh)
        tag = f"gather-route total(fuse_edges={fuse})"
        check_close(f"{tag} energy", vk, vp, ENERGY_RTOL, 0.0)
        check_close(f"{tag} d/d coords", gck, gcp, GRAD_RTOL, GRAD_ATOL)
        check_close(f"{tag} d/d u", guk, gup, GRAD_RTOL, GRAD_ATOL)
        kms, pms = ab_ms(lambda: value_and_grads(ek, params, mesh),
                         lambda: value_and_grads(ep, params, mesh))
        log(f"  value-and-grad {tag} at {mesh.n_elements} elements: "
            f"kernel path {kms:.4f} ms, plain path {pms:.4f} ms [{card}]")
    src = "hidenn_fem_tpu_torch/csrc/element_energy.cu"
    return [
        {"name": "element_energy_fwd", "route": "cuda", "source": src,
         "replaces": "hidenn_fem_tpu/ops/pallas_energy.py:154",
         "launches": None, "max_abs_err": err1, "ms": ms1,
         "plain_ms": pms1},
        {"name": "element_energy_bwd", "route": "cuda", "source": src,
         "replaces": "hidenn_fem_tpu/ops/pallas_energy.py:178",
         "launches": None, "max_abs_err": err2, "ms": ms2,
         "plain_ms": pms2},
        {"name": "incidence_sum", "route": "cuda", "source": src,
         "replaces": "hidenn_fem_tpu/ops/assembly.py:113",
         "launches": None, "max_abs_err": err3, "ms": ms3,
         "plain_ms": pms3},
    ]


def stencil_ab(ls, tag, node, nx, ny, E, nu, w_sum, kw, card):
    """K7 and K6 against their plain versions on one lattice: checks and
    times; returns {kernel: (max_abs_err, ms, plain_ms)}."""
    k7 = ls.lattice_stencil_fwd(node, nx, ny, E, nu, w_sum, **kw)
    p7 = ls.lattice_stencil_fwd_plain(node, nx, ny, E, nu, w_sum, **kw)
    err7 = check_close(f"{tag} K7 lattice_stencil_fwd vs plain", k7, p7,
                       ENERGY_RTOL, 0.0)
    e6, g6 = ls.lattice_stencil_vg(node, nx, ny, E, nu, w_sum, **kw)
    pe6, pg6 = ls.lattice_stencil_vg_plain(node, nx, ny, E, nu, w_sum, **kw)
    check_close(f"{tag} K6 energy vs plain", e6, pe6, ENERGY_RTOL, 0.0)
    err6 = check_close(f"{tag} K6 node gradient vs plain", g6, pg6,
                       GRAD_RTOL, GRAD_ATOL)
    na = node.detach().clone().requires_grad_(True)
    (auto,) = torch.autograd.grad(
        ls.lattice_stencil_fwd_plain(na, nx, ny, E, nu, w_sum, **kw), na)
    check_close(f"{tag} K6 node gradient vs autograd(plain K7)", g6, auto,
                GRAD_RTOL, GRAD_ATOL)
    if float(e6) != float(k7):
        raise AssertionError(f"{tag}: K6 and K7 energies differ "
                             f"({float(e6)!r} vs {float(k7)!r})")
    torch.cuda.synchronize()
    ms7, pms7 = ab_ms(
        lambda: ls.lattice_stencil_fwd(node, nx, ny, E, nu, w_sum, **kw),
        lambda: ls.lattice_stencil_fwd_plain(node, nx, ny, E, nu, w_sum,
                                             **kw))
    ms6, pms6 = ab_ms(
        lambda: ls.lattice_stencil_vg(node, nx, ny, E, nu, w_sum, **kw),
        lambda: ls.lattice_stencil_vg_plain(node, nx, ny, E, nu, w_sum,
                                            **kw))
    quads = (nx - 1) * (ny - 1)
    log(f"  {tag} K7 fwd at {nx}x{ny} ({quads} quads): kernel {ms7:.4f} ms,"
        f" plain {pms7:.4f} ms [{card}]")
    log(f"  {tag} K6 vg at {nx}x{ny} ({quads} quads): kernel {ms6:.4f} ms, "
        f"plain (hand-derived gradient in torch) {pms6:.4f} ms [{card}]")
    return {"lattice_stencil_fwd": (err7, ms7, pms7),
            "lattice_stencil_vg": (err6, ms6, pms6)}


def phase_lattice(ht, ls, mesh, dev, card):
    """Phase 3b: K6/K7 and the lattice-route energy on the 922K plate."""
    params = perturbed_params(ht, mesh, dev)
    model = ht.TriangleP1()
    route = mesh.lattice
    node = model.packed_nodes(params, mesh).contiguous()
    res = stencil_ab(ls, "922K zigzag+holes", node, route.nx, route.ny,
                     10e9, 0.3, 0.5, ls.route_stencil(route), card)

    ek = ht.PlaneStressEnergy(model=model, backend="kernel")
    ep = ht.PlaneStressEnergy(model=model, backend="plain")
    before = dict(ls.launch_counts)
    vk, gck, guk = value_and_grads(ek, params, mesh)
    if ls.launch_counts["lattice_stencil_vg"] == before["lattice_stencil_vg"]:
        raise AssertionError("the lattice-route kernel path did not "
                             "launch K6")
    vp, gcp, gup = value_and_grads(ep, params, mesh)
    tag = "lattice-route total"
    check_close(f"{tag} energy", vk, vp, ENERGY_RTOL, 0.0)
    check_close(f"{tag} d/d coords", gck, gcp, GRAD_RTOL, GRAD_ATOL)
    check_close(f"{tag} d/d u", guk, gup, GRAD_RTOL, GRAD_ATOL)
    kms, pms = ab_ms(lambda: value_and_grads(ek, params, mesh),
                     lambda: value_and_grads(ep, params, mesh))
    log(f"  value-and-grad {tag} at {mesh.n_elements} elements: kernel "
        f"path {kms:.4f} ms, plain path {pms:.4f} ms [{card}]")
    return res


def phase_structured(ls, dev, card):
    """Phase 3c: K6/K7 on the hole-free 961x481 "up" StructuredGridP1."""
    from hidenn_fem_tpu_torch.models.structured_grid import (
        StructuredGridP1, generate_structured_grid)

    grid = generate_structured_grid(nx=961, ny=481, split="up", device=dev)
    model = StructuredGridP1()
    params = model.init(np.random.default_rng(1), grid)
    params["u"] = params["u"] * 10.0
    node = model._node(params, grid).reshape(-1, 4).contiguous()
    qm = grid.quad_mask
    stencil_ab(ls, "961x481 structured up", node, grid.nx, grid.ny,
               model.E, model.nu, 0.5, dict(diag=ls.UP, t1=qm, t2=qm), card)


def plate_energy(ht, cfg, model):
    return ht.PlaneStressEnergy(
        model=model, E=cfg.youngs_modulus, nu=cfg.poisson_ratio,
        gauss_order=cfg.gauss_order, gauss_order_1d=cfg.gauss_order_1d,
        F_total=cfg.traction_total, traction_length=cfg.traction_length)


def solve_example4(ht, mesh, dev, card, want, route_name):
    """Example 4's 600-step solve on ``mesh``; checks the final energy
    against the JAX value ``want`` and the von Mises stress."""
    from hidenn_fem_tpu_torch import postproc
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    model = ht.TriangleP1(u_fixed=0.0)
    energy = plate_energy(ht, cfg, model)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    # warm-up outside the timed solve: the first L-BFGS steps of a process
    # load the solver's kernels and libraries
    ht.run_lbfgs(energy.total, params, num_steps=3, loss_args=(mesh,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(energy.total, params,
                                  num_steps=cfg.lbfgs_steps,
                                  loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    with torch.no_grad():
        at_solution = float(energy.total(params, mesh))
    losses = losses.cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite energy in the {route_name} solve")
    for i in range(0, cfg.lbfgs_steps, 100):
        log(f"  Iter {i:04d}: Loss = {losses[i]:.6e}")
    final = float(losses[-1])
    rel = abs(final - want) / abs(want)
    log(f"  {route_name}: final energy {final!r} vs JAX {want!r}: rel "
        f"{rel:.3e} (limit {EX4_RTOL})")
    if rel > EX4_RTOL:
        raise AssertionError(f"example-4 {route_name} final energy off the "
                             "JAX value")
    rel2 = abs(at_solution - final) / abs(final)
    log(f"  {route_name}: energy at the solution under no_grad "
        f"{at_solution!r} vs the last loss: rel {rel2:.3e} "
        f"(limit {EX4_RTOL})")
    if rel2 > EX4_RTOL:
        raise AssertionError("no_grad energy at the solution off the last "
                             "loss")
    vm = postproc.von_mises_per_element(model, params, mesh,
                                        cfg.youngs_modulus,
                                        cfg.poisson_ratio)
    vm_max = float(vm.max())
    if not (np.isfinite(vm_max) and vm_max > 0.0
            and bool(torch.isfinite(vm).all())):
        raise AssertionError(f"bad von Mises stress (max {vm_max})")
    log(f"  {route_name}: max von Mises stress {vm_max:.6e}")
    log(f"  example-4 {route_name} 600-step solve: {seconds:.3f} s "
        f"({1e3 * seconds / cfg.lbfgs_steps:.4f} ms/iter) [{card}]")


def example4_mesh(ht, dev):
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    mesh = ht.generate_mesh(cfg.length, cfg.height, list(cfg.holes),
                            cfg.make_boundaries(), cfg.nx, cfg.ny,
                            keep_dead_nodes=True, device=dev)
    log(f"  example-4 plate: {mesh.n_nodes} nodes, {mesh.n_elements} "
        f"elements, {mesh.n_neumann_edges} Neumann edges; lattice route "
        f"{mesh.lattice.nx}x{mesh.lattice.ny}, identity "
        f"{mesh.lattice.identity}")
    return mesh


def phase_example6(dev, card):
    """Phase 6: example 6 at full size; returns the solve's loss history."""
    from examples.example6_structured_torch import main as example6

    t0 = time.perf_counter()
    _, losses, vm, final = example6(device=dev)
    seconds = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"example-6 energy did not fall: {losses[0]} "
                             f"-> {losses[-1]}")
    vm_max = float(vm.max())
    if not (bool(torch.isfinite(vm).all()) and vm_max > 0.0):
        raise AssertionError(f"bad example-6 von Mises stress ({vm_max})")
    if not np.isfinite(final):
        raise AssertionError("non-finite example-6 energy at the solution")
    log(f"  example 6: energy {losses[0]:.6e} -> {losses[-1]:.6e} in "
        f"{len(losses)} steps, {final:.6e} at the solution; max von Mises "
        f"{vm_max:.6e}; {seconds:.3f} s with set-up and post-processing "
        f"[{card}]")
    at = float(losses[EX6_COMPARE_STEP])
    rel = abs(at - JAX_EX6_F32_AT_STEP) / abs(JAX_EX6_F32_AT_STEP)
    log(f"  example 6 at step {EX6_COMPARE_STEP}: {at!r} vs JAX f32 "
        f"{JAX_EX6_F32_AT_STEP!r} (f64 {JAX_EX6_F64_AT_STEP!r}): rel "
        f"{rel:.3e} (limit {EX6_RTOL})")
    if rel > EX6_RTOL:
        raise AssertionError("example-6 energy off the JAX value")
    rel = abs(float(losses[-1]) - JAX_EX6_F64_FINAL) / abs(JAX_EX6_F64_FINAL)
    log(f"  example 6 after {len(losses)} steps: {float(losses[-1])!r} vs "
        f"JAX f64 {JAX_EX6_F64_FINAL!r}: rel {rel:.3e} (limit "
        f"{EX6_FINAL_RTOL}, the spread of the reference runs)")
    if rel > EX6_FINAL_RTOL:
        raise AssertionError("example-6 final energy outside the spread "
                             "of the reference runs")
    return losses


def phase_scale(ht, mesh, dev, card, steps=50):
    """Phase 7: L-BFGS on the 922K-class plate, lattice route."""
    model = ht.TriangleP1()
    energy = ht.PlaneStressEnergy(model=model)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    ht.run_lbfgs(energy.total, params, num_steps=3, loss_args=(mesh,))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, losses = ht.run_lbfgs(energy.total, params, num_steps=steps,
                             loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    losses = losses.cpu().numpy()
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite energy in the 922K-class solve")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"922K-class solve did not descend: "
                             f"{losses[0]} -> {losses[-1]}")
    log(f"  922K-class L-BFGS: energy {losses[0]:.6e} -> "
        f"{losses[-1]:.6e} in {steps} steps")
    log(f"  922K-class L-BFGS (lattice route) at {mesh.n_elements} "
        f"elements: {1e3 * seconds / steps:.4f} ms/iter [{card}]")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on a GPU")
    import hidenn_fem_tpu_torch as ht
    from hidenn_fem_tpu_torch.ops import cuda_build
    from hidenn_fem_tpu_torch.ops import element_energy as ee
    from hidenn_fem_tpu_torch.ops import lattice_slab as ls

    counts = Counts(ee, ls)
    log("[1/7] environment")
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    log("  TF32 off for matmul and cuDNN")

    log("[2/7] build")
    build = cuda_build.build_kernels()
    for stem, path in build["libraries"].items():
        log(f"  {stem}: {path}")
    log(f"  built in {build['seconds']:.2f} s (one nvcc per source, in "
        "parallel)")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    log("[3/7] kernel vs plain at full size")
    mesh922 = plate_922k(ht, dev)
    kernels = phase_gather(ht, ee, mesh922, dev, card)
    stencil = phase_lattice(ht, ls, mesh922, dev, card)
    phase_structured(ls, dev, card)
    for name, line in (("lattice_stencil_vg", ":346"),
                       ("lattice_stencil_fwd", ":365")):
        err, ms, pms = stencil[name]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "hidenn_fem_tpu_torch/csrc/lattice_stencil.cu",
             "replaces": "hidenn_fem_tpu/ops/lattice_slab.py" + line,
             "launches": None, "max_abs_err": err, "ms": ms,
             "plain_ms": pms})

    mesh4 = example4_mesh(ht, dev)
    log("[4/7] example 4 on its default route (lattice), 600 steps")
    _, lattice_launches = run_path(
        counts, "example-4 lattice-route",
        ("lattice_stencil_vg", "lattice_stencil_fwd"),
        lambda: solve_example4(ht, mesh4, dev, card,
                               JAX_EX4_LATTICE_FINAL_ENERGY,
                               "lattice route"))

    log("[5/7] example 4 on the gather route (lattice stripped), 600 steps")
    _, gather_launches = run_path(
        counts, "example-4 gather-route",
        ("element_energy_fwd", "element_energy_bwd", "incidence_sum"),
        lambda: solve_example4(ht, dataclasses.replace(mesh4, lattice=None),
                               dev, card, JAX_EX4_FINAL_ENERGY,
                               "gather route"))
    for k in kernels:
        k["launches"] = (lattice_launches[k["name"]]
                         if k["name"].startswith("lattice_")
                         else gather_launches[k["name"]])

    log("[6/7] example 6: 1000x500 structured plate, 600 steps")
    run_path(counts, "example-6", ("lattice_stencil_vg",
                                   "lattice_stencil_fwd"),
             lambda: phase_example6(dev, card))

    log("[7/7] scale: 922K-class plate, 50 L-BFGS steps, lattice route")
    run_path(counts, "922K-class", ("lattice_stencil_vg",),
             lambda: phase_scale(ht, mesh922, dev, card))

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
