#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``hidenn_fem_tpu_torch``) on one CUDA
card, the quickest proof that the port still starts on the GPU.

Run from the repository root:  ``python3 chip_smoke.py``

Phases (each raises on failure, and the script then exits non-zero):

1. Environment: CUDA is required; prints the card's name and power limit
   and checks that TF32 is off.
2. Build: compiles ``hidenn_fem_tpu_torch/csrc/element_energy.cu`` for
   sm_90a (nvcc, into ``hidenn_fem_tpu_torch/csrc/build/``).
3. Kernel vs plain at full size: on the 922K-class plate
   (``generate_mesh(nx=961, ny=481, keep_dead_nodes=True)``, three
   reference holes: 852,676 elements) each kernel wrapper (K1 energy,
   K2 corner cotangents, the incidence-table node-gradient sum) against
   its plain torch version, then the energy and both gradient groups of
   ``PlaneStressEnergy`` on the kernel path against the plain path, with
   and without ``fuse_edges``.
4. Main path: example 4 (``PlateConfig()``, 36,237 elements), 600
   ``run_lbfgs`` steps on the kernel path from u0 = 1e-5 N(0,1)
   (``np.random.default_rng(0)``); the final energy is held against the
   JAX package's value for the same init (``JAX_EX4_FINAL_ENERGY``).
   Every kernel's launch count is read from this run.
5. Scale: 50 L-BFGS steps on the 922K-class plate.

The last three lines of standard output are the kernels' JSON, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# Final energy of example 4 in the JAX package (f32, CPU, gather route:
# lattice stripped) after 600 L-BFGS steps from the init above, made with
#   JAX_PLATFORMS=cpu python -c "
#   import dataclasses, numpy as np, jax.numpy as jnp, hidenn_fem_tpu as ht
#   from hidenn_fem_tpu.config import PlateConfig
#   c = PlateConfig()
#   m = dataclasses.replace(ht.generate_mesh(c.length, c.height,
#       list(c.holes), c.make_boundaries(), c.nx, c.ny,
#       keep_dead_nodes=True), lattice=None)
#   u0 = 1e-5 * np.random.default_rng(0).standard_normal((m.n_nodes, 2))
#   e = ht.PlaneStressEnergy(model=ht.TriangleP1())
#   _, l = ht.run_lbfgs(e.total, {'coords': m.coords,
#       'u': jnp.asarray(u0, jnp.float32)}, num_steps=600, loss_args=(m,))
#   print(float(l[-1]))"
JAX_EX4_FINAL_ENERGY = -1.3143504858016968
EX4_RTOL = 2e-3

# kernel vs plain tolerances at 852,676 elements (f32 on both sides, sums
# and products in other orders): energy rtol 1e-4; gradients rtol 5e-4
# with atol GRAD_ATOL x max|grad| per group.  Coordinate gradients are sums
# of cancelling terms whose f32 value lies ~4e-6 x max|grad| from an f64
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


def plate_922k(ht, dev):
    t0 = time.perf_counter()
    mesh = ht.generate_mesh(nx=961, ny=481, keep_dead_nodes=True,
                            device=dev)
    log(f"  922K-class plate: {mesh.n_nodes} nodes, {mesh.n_elements} "
        f"elements, {mesh.n_neumann_edges} Neumann edges, incidence "
        f"{tuple(mesh.incidence.shape)} "
        f"({time.perf_counter() - t0:.2f} s on the host)")
    if mesh.n_elements != 852_676:
        raise AssertionError(f"expected 852676 elements, got "
                             f"{mesh.n_elements}")
    return mesh


def phase_kernels(ht, ee, mesh, dev, card):
    """Phase 3: every kernel wrapper and the energy, kernel vs plain."""
    from hidenn_fem_tpu_torch.ops.assembly import flat_gather

    rng = np.random.default_rng(0)
    n = mesh.n_nodes
    coords = mesh.coords.cpu().numpy().astype(np.float64)
    params = ht.params_from_numpy(
        {"coords": coords + 1e-3 * rng.standard_normal((n, 2)),
         "u": 1e-4 * rng.standard_normal((n, 2))}, device=dev)
    model = ht.TriangleP1()
    E, nu, w_sum = 10e9, 0.3, 0.5
    node = model.packed_nodes(params, mesh).contiguous()
    conn = mesh.connectivity

    # K1: energy; K2: corner cotangents (vs the hand formula in torch and
    # vs autograd of the plain energy)
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
    # the node-gradient assembly through the incidence table
    from hidenn_fem_tpu_torch.ops.assembly import assemble_node_grad
    inc = mesh.incidence
    k3 = ee.incidence_sum(k2, inc)
    p3 = assemble_node_grad(k2, conn, inc, n)
    err3 = check_close("incidence_sum vs plain gather-sum", k3, p3,
                       GRAD_RTOL, GRAD_ATOL)
    # the fused-edge variant of K1 and K2
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

    # the energy with both gradient groups, kernel path vs plain path
    vg = {}
    for fuse in (False, True):
        ek = ht.PlaneStressEnergy(model=model, backend="kernel",
                                  fuse_edges=fuse)
        ep = ht.PlaneStressEnergy(model=model, backend="plain",
                                  fuse_edges=fuse)
        before = dict(ee.launch_counts)
        vk, gck, guk = value_and_grads(ek, params, mesh)
        grew = {k: ee.launch_counts[k] - before[k] for k in before}
        if min(grew.values()) < 1:
            raise AssertionError(f"kernel path launched {grew}")
        vp, gcp, gup = value_and_grads(ep, params, mesh)
        tag = f"total(fuse_edges={fuse})"
        check_close(f"{tag} energy", vk, vp, ENERGY_RTOL, 0.0)
        check_close(f"{tag} d/d coords", gck, gcp, GRAD_RTOL, GRAD_ATOL)
        check_close(f"{tag} d/d u", guk, gup, GRAD_RTOL, GRAD_ATOL)
        vg[fuse] = ab_ms(lambda: value_and_grads(ek, params, mesh),
                         lambda: value_and_grads(ep, params, mesh))
        log(f"  value-and-grad {tag} at {mesh.n_elements} elements: "
            f"kernel path {vg[fuse][0]:.4f} ms, plain path "
            f"{vg[fuse][1]:.4f} ms [{card}]")
    return [
        {"name": "element_energy_fwd", "route": "cuda",
         "source": "hidenn_fem_tpu_torch/csrc/element_energy.cu",
         "replaces": "hidenn_fem_tpu/ops/pallas_energy.py:154",
         "launches": None, "max_abs_err": err1, "ms": ms1,
         "plain_ms": pms1},
        {"name": "element_energy_bwd", "route": "cuda",
         "source": "hidenn_fem_tpu_torch/csrc/element_energy.cu",
         "replaces": "hidenn_fem_tpu/ops/pallas_energy.py:178",
         "launches": None, "max_abs_err": err2, "ms": ms2,
         "plain_ms": pms2},
        {"name": "incidence_sum", "route": "cuda",
         "source": "hidenn_fem_tpu_torch/csrc/element_energy.cu",
         "replaces": "hidenn_fem_tpu/ops/assembly.py:113",
         "launches": None, "max_abs_err": err3, "ms": ms3,
         "plain_ms": pms3},
    ]


def phase_example4(ht, ee, dev, card):
    """Phase 4: the main path, example 4 on the kernel path."""
    from hidenn_fem_tpu_torch import postproc
    from hidenn_fem_tpu_torch.config import PlateConfig

    cfg = PlateConfig()
    mesh = ht.generate_mesh(cfg.length, cfg.height, list(cfg.holes),
                            cfg.make_boundaries(), cfg.nx, cfg.ny,
                            keep_dead_nodes=True, device=dev)
    log(f"  example-4 plate: {mesh.n_nodes} nodes, {mesh.n_elements} "
        f"elements, {mesh.n_neumann_edges} Neumann edges")
    model = ht.TriangleP1(u_fixed=0.0)
    u0 = 1e-5 * np.random.default_rng(0).standard_normal((mesh.n_nodes, 2))
    params = ht.params_from_numpy(
        {"coords": mesh.coords.cpu().numpy(), "u": u0}, device=dev)
    energy = ht.PlaneStressEnergy(
        model=model, E=cfg.youngs_modulus, nu=cfg.poisson_ratio,
        gauss_order=cfg.gauss_order, gauss_order_1d=cfg.gauss_order_1d,
        F_total=cfg.traction_total, traction_length=cfg.traction_length)

    torch.cuda.synchronize()
    ee.reset_launch_counts()
    t0 = time.perf_counter()
    params, losses = ht.run_lbfgs(energy.total, params,
                                  num_steps=cfg.lbfgs_steps,
                                  loss_args=(mesh,))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(ee.launch_counts)
    losses = losses.cpu().numpy()
    log(f"  launches in the main path: {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"{name} was not launched by the main path")
    if not np.all(np.isfinite(losses)):
        raise AssertionError("non-finite energy in the example-4 solve")
    final = float(losses[-1])
    for i in range(0, cfg.lbfgs_steps, 100):
        log(f"  Iter {i:04d}: Loss = {losses[i]:.6e}")
    rel = abs(final - JAX_EX4_FINAL_ENERGY) / abs(JAX_EX4_FINAL_ENERGY)
    log(f"  final energy {final!r} vs JAX {JAX_EX4_FINAL_ENERGY!r}: "
        f"rel {rel:.3e} (limit {EX4_RTOL})")
    if rel > EX4_RTOL:
        raise AssertionError("example-4 final energy off the JAX value")
    vm = postproc.von_mises_per_element(model, params, mesh,
                                        cfg.youngs_modulus,
                                        cfg.poisson_ratio)
    vm_max = float(vm.max())
    if not (np.isfinite(vm_max) and vm_max > 0.0
            and bool(torch.isfinite(vm).all())):
        raise AssertionError(f"bad von Mises stress (max {vm_max})")
    log(f"  max von Mises stress {vm_max:.6e}")
    log(f"  example-4 600-step solve: {seconds:.3f} s "
        f"({1e3 * seconds / cfg.lbfgs_steps:.4f} ms/iter) [{card}]")
    return launches


def phase_scale(ht, mesh, dev, card, steps=50):
    """Phase 5: L-BFGS on the 922K-class plate, kernel path."""
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
    log(f"  922K-class L-BFGS at {mesh.n_elements} elements: "
        f"{1e3 * seconds / steps:.4f} ms/iter [{card}]")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on a GPU")
    import hidenn_fem_tpu_torch as ht
    from hidenn_fem_tpu_torch.ops import element_energy as ee

    log("[1/5] environment")
    card = card_line()
    dev = torch.device("cuda", 0)
    log(f"  card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, python {sys.version.split()[0]}")
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 must be off")
    log("  TF32 off for matmul and cuDNN")

    log("[2/5] build")
    build = ee.build_kernels()
    log(f"  built {build['path']} in {build['seconds']:.2f} s")
    for line in build["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"  ptxas: {line.strip()}")

    log("[3/5] kernel vs plain at 852,676 elements")
    mesh922 = plate_922k(ht, dev)
    kernels = phase_kernels(ht, ee, mesh922, dev, card)

    log("[4/5] main path: example 4, 600 L-BFGS steps")
    launches = phase_example4(ht, ee, dev, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]

    log("[5/5] scale: 922K-class plate, 50 L-BFGS steps")
    phase_scale(ht, mesh922, dev, card)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
