"""Shared inputs for the port's tests (``tests/test_torch_*.py``): one
numpy mesh and one set of numpy params feed both packages, since the JAX
and torch generators give different numbers from the same seed.

The port's entry points put their tensors on the card unless told
otherwise; these tests run on the CPU and ask for it at every call
(``device=CPU``).

Importing this module puts torch on one thread for the whole process.
The port's CPU solves are chains of small eager ops, and with several
test workers on the cores torch's intra-op pools only slow them (the
Tier-1 run, six workers on an 8-core host: 546 s at torch's default
eight threads a worker, 245 s at one).  Every test worker collects
every test module, so this reaches every test that runs in one;
processes the tests spawn set their own threads."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt

CPU = torch.device("cpu")
torch.set_num_threads(1)


def jax_mesh(*, holes=(), nx=17, ny=9, variant="zigzag",
             keep_dead_nodes=False, boundaries=None, dtype=jnp.float32):
    """A JAX-package plate mesh with the lattice route stripped, so the
    JAX energy takes the gather route (``port_mesh`` strips it too)."""
    m = ht.generate_mesh(holes=list(holes), nx=nx, ny=ny, variant=variant,
                         keep_dead_nodes=keep_dead_nodes,
                         boundaries=boundaries)
    if dtype != jnp.float32:
        m = ht.TriMesh.from_arrays(*[np.asarray(a) for a in m.astuple()],
                                   dtype=dtype)
    return dataclasses.replace(m, lattice=None)


def port_mesh(mesh_jax, dtype=torch.float32):
    """The port's mesh of the same arrays, with a lattice route exactly
    when the JAX mesh has one, so both packages take the same route."""
    return pt.mesh_from_numpy(mesh_jax, device=CPU, dtype=dtype,
                              build_lattice=mesh_jax.lattice is not None)


def assert_route_equal(port_route, jax_route):
    """The port's LatticeRoute holds the JAX package's arrays and static
    flags (exact equality)."""
    assert (port_route is None) == (jax_route is None)
    if jax_route is None:
        return
    for name in ("sel", "t1", "t2", "inv_map", "fwd_map"):
        np.testing.assert_array_equal(getattr(port_route, name).numpy(),
                                      np.asarray(getattr(jax_route, name)),
                                      err_msg=name)
    assert sorted(port_route.edge_masks) == sorted(jax_route.edge_masks)
    for face, mask in jax_route.edge_masks.items():
        np.testing.assert_array_equal(port_route.edge_masks[face].numpy(),
                                      np.asarray(mask), err_msg=face)
    for name in ("nx", "ny", "identity", "prefix_identity", "uniform_sel",
                 "all_present"):
        assert getattr(port_route, name) == getattr(jax_route, name), name


def random_params(mesh_jax, seed=0, u_scale=1e-4, coord_scale=1e-3):
    """numpy params: u ~ u_scale N(0,1), coords perturbed by
    coord_scale N(0,1) (pinned nodes are re-pinned by the models)."""
    rng = np.random.default_rng(seed)
    coords = np.asarray(mesh_jax.coords, dtype=np.float64)
    n = coords.shape[0]
    return {"coords": coords + coord_scale * rng.standard_normal((n, 2)),
            "u": u_scale * rng.standard_normal((n, 2))}


def to_jax(params_np, dtype=jnp.float32):
    return {k: jnp.asarray(v, dtype=dtype) for k, v in params_np.items()}


def to_torch(params_np, dtype=torch.float32, requires_grad=False):
    p = pt.params_from_numpy(params_np, device=CPU, dtype=dtype)
    if requires_grad:
        for v in p.values():
            v.requires_grad_(True)
    return p


# the dtype pairs of the f32 and f64 comparisons: (JAX dtype, torch dtype)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "f64": (jnp.float64, torch.float64)}


def set_both(jax_params, port_params, dt, **arrays):
    """Put the same numpy arrays into a JAX and a port params dict, in
    the dtypes of ``DTYPES[dt]``."""
    jdt, tdt = DTYPES[dt]
    for k, v in arrays.items():
        jax_params[k] = jnp.asarray(v, jdt)
        port_params[k] = torch.tensor(np.asarray(v), dtype=tdt)


def value_and_grads(loss, params):
    """(loss value, {key: gradient}) of ``loss(params)`` for a port params
    dict, by autograd on detached copies."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    val = loss(p)
    keys = sorted(p)
    return val.detach(), dict(zip(keys, torch.autograd.grad(
        val, [p[k] for k in keys])))


def assert_close(actual, expected, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)
