"""Physics validation of the port (the mirror of
``tests/test_physics_validation.py``'s four checks at 41x21), with the
JAX tests' own bounds.

A hole-free plate clamped on the left and pulled by a uniform traction
t = F/L on the right approaches the uniform uniaxial plane-stress state
away from the clamped edge: sigma_xx = t, sigma_yy = sigma_xy = 0,
u_x ~ (t/E) x.  The port solves it with its own ``run_lbfgs`` (500
steps, coordinates frozen) from the JAX test's initial displacement
(``TriangleP1().init(PRNGKey(0))``, carried across as numpy), in f32 on
the CPU, on the lattice route both packages take there.
"""

import jax
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch.ops.elasticity import (plane_stress_C,
                                                 strain_voigt_from_grad,
                                                 stress_from_strain)
from hidenn_fem_tpu_torch.postproc import von_mises_per_element

from torch_port_common import CPU, port_mesh

E, NU, F_TOTAL = 10e9, 0.3, 100e3
T = F_TOTAL / 1.0          # the traction on the unit-height right face


@pytest.fixture(scope="module")
def solved_plate():
    jm = ht.proxy_plate_mesh(nx=41, ny=21)
    u0 = np.asarray(ht.TriangleP1().init(jax.random.PRNGKey(0), jm)["u"])
    mesh = port_mesh(jm)
    model = pt.TriangleP1()
    coords0 = mesh.coords.clone()
    energy = pt.PlaneStressEnergy(model=model, E=E, nu=NU,
                                  F_total=F_TOTAL)

    def loss(p):
        return energy({"u": p["u"], "coords": coords0}, mesh)
    u = torch.tensor(u0, dtype=torch.float32)
    pf, losses = pt.run_lbfgs(loss, {"u": u}, num_steps=500)
    params = {"u": pf["u"], "coords": coords0}
    return mesh, model, params, energy, losses


def _far_field(model, params, mesh):
    """Centroids of the elements more than one plate height from the
    clamp."""
    coords = model.coords(params, mesh).numpy()
    cent = coords[mesh.connectivity.numpy()].mean(axis=1)
    return cent[:, 0] > 1.0


def test_energy_matches_clapeyron(solved_plate):
    """At equilibrium the total potential equals -(1/2) x external
    work."""
    mesh, model, params, energy, losses = solved_plate
    assert np.all(np.isfinite(losses.numpy()))
    total = float(energy(params, mesh))
    work = float(energy.edge_energy(params, mesh))
    assert total == pytest.approx(-0.5 * work, rel=1e-3)


def test_uniform_stress_away_from_clamp(solved_plate):
    mesh, model, params, _, _ = solved_plate
    _, grad_u = model.element_fields(params, mesh)
    sigma = stress_from_strain(strain_voigt_from_grad(grad_u),
                               plane_stress_C(E, NU, device=CPU)).numpy()
    far = _far_field(model, params, mesh)
    assert np.median(sigma[far, 0]) == pytest.approx(T, rel=0.02)
    assert np.abs(sigma[far, 1]).max() < 0.1 * T      # sigma_yy ~ 0
    assert np.abs(sigma[far, 2]).max() < 0.1 * T      # sigma_xy ~ 0


def test_displacement_profile(solved_plate):
    """u_x grows ~ (t/E) x away from the clamp; tip displacement close
    to t L / E."""
    mesh, model, params, _, _ = solved_plate
    u = model.u_full(params, mesh).numpy()
    coords = model.coords(params, mesh).numpy()
    tip = np.abs(coords[:, 0] - 2.0) < 1e-6
    assert u[tip, 0].mean() == pytest.approx(T * 2.0 / E, rel=0.05)


def test_von_mises_uniform_far_field(solved_plate):
    mesh, model, params, _, _ = solved_plate
    vm = von_mises_per_element(model, params, mesh, E, NU).numpy()
    far = _far_field(model, params, mesh)
    assert np.median(vm[far]) == pytest.approx(T, rel=0.03)
