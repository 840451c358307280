"""Shared inputs for the port's tests (``tests/test_torch_*.py``): one
numpy mesh and one set of numpy params feed both packages, since the JAX
and torch generators give different numbers from the same seed."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt


def jax_mesh(*, holes=(), nx=17, ny=9, variant="zigzag",
             keep_dead_nodes=False, boundaries=None, dtype=jnp.float32):
    """A JAX-package plate mesh with the lattice route stripped, so the
    JAX energy takes the gather route the port has."""
    m = ht.generate_mesh(holes=list(holes), nx=nx, ny=ny, variant=variant,
                         keep_dead_nodes=keep_dead_nodes,
                         boundaries=boundaries)
    if dtype != jnp.float32:
        m = ht.TriMesh.from_arrays(*[np.asarray(a) for a in m.astuple()],
                                   dtype=dtype)
    return dataclasses.replace(m, lattice=None)


def port_mesh(mesh_jax, dtype=torch.float32):
    return pt.mesh_from_numpy(mesh_jax, dtype=dtype)


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
    p = pt.params_from_numpy(params_np, dtype=dtype)
    if requires_grad:
        for v in p.values():
            v.requires_grad_(True)
    return p


def assert_close(actual, expected, rtol, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(actual, dtype=np.float64),
                               np.asarray(expected, dtype=np.float64),
                               rtol=rtol, atol=atol, err_msg=what)
