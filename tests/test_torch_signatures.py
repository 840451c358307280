"""The port's public surface against the JAX package's, module by module.

For every module of ``hidenn_fem_tpu_torch`` that has a counterpart in
``hidenn_fem_tpu``: each name of the JAX module's ``__all__`` exists in the
port (or is listed below as not yet ported, with its ROADMAP item, or as a
deliberate difference); each common function, class and public method
takes the JAX parameters, in the JAX order, and adds only the keyword
parameters listed below; each common dataclass has the JAX fields.

Deliberate differences, and why:
* ``interpret``: a Pallas flag for running TPU kernels on the CPU; the
  port's wrappers run their plain versions for CPU tensors instead.
* a ``torch.Generator`` (``generator``) where the JAX models take a PRNG
  ``key``; the two give different numbers from one seed anyway.
* ``device`` (and ``dtype`` on the mesh generators): the port's entry
  points put their tensors on the card unless told otherwise.
* ``Mesh``/``NamedSharding``: torch has no global sharded arrays, so
  ``mesh_shardings`` has no counterpart and ``device_mesh`` returns a
  ``DeviceMesh`` descriptor (group, rank, size, device) over the process
  group, which the sharded functions take where the JAX package takes a
  ``Mesh`` (``aux_pcg_solve_sharded``'s ``dmesh`` among them);
  ``initialize_multihost`` takes the ``backend`` (NCCL or gloo).
* ``row_start`` on ``banded_element_energy``: the JAX package's private
  ``_banded_energy_rows`` made public for the sharded banded route.
* ``backend`` on ``StructuredGridP1`` (kernel or plain), and ``tol`` on
  ``run_optimizer`` (the JAX package has it on ``run_lbfgs`` only).
* The optimizers (``adam``, ``adam_per_group``, ``freeze_groups``,
  ``lbfgs``) return objects with ``init(x, like=None)`` and
  ``update(g, state, x)`` on one flat vector, not optax transformations
  on a pytree: ``like`` is the params template, from which
  ``adam_per_group`` and ``freeze_groups`` find each top-level key's
  entries (``run_optimizer`` passes it; L-BFGS ignores it).
* ``dtype`` on ``grid_from_numpy`` and ``levels_from_numpy`` (the port's
  own converters), and ``lmax_host`` on the multigrid levels (the
  Chebyshev bound on the host, read once at set-up).
* The sharded multigrid (``parallel.sharded_mg``) takes the same
  ``DeviceMesh`` as ``dmesh`` where the JAX package takes a ``Mesh``, and
  its ``count_collectives`` counts the port's own collective calls
  (by kind: ``all_reduce``, ``broadcast``) where the JAX package counts
  collective HLOs of a compiled program.
* The 1D and bilinear models and the wrappers take a ``torch.Generator``
  (``generator``) where the JAX package takes a ``seed`` or a PRNG
  ``key`` (``Bilinear2D.create``/``init``, the structured and triangular
  wrappers), and ``device``; ``Bilinear2D.node_mask`` takes ``device``.
* ``postproc.locate_points`` finds the triangles without matplotlib (a
  bucket grid and a barycentric test, in torch on the coordinates'
  device) where the JAX package asks matplotlib's trifinder; it returns
  tensors with the JAX package's contract.
* ``plots`` needs matplotlib and the package's ``__init__`` never
  imports it, as in the JAX package.
* ``LatticeRoute``'s 16 windowed and chunked fill fields (``fw_*``,
  ``bw_*``, ``ck_*``): the JAX package's TPU layout experiments for the
  renumbered lattice's permutation fill, which its detection builds only
  under ``HDNN_LATTICE_CHUNK=1`` (chunked) or never (windowed).  Both
  copy the flat fill's rows; the port keeps the one flat fill and
  ignores ``HDNN_LATTICE_CHUNK``.
* ``ops.pallas_energy`` (``element_energy_pallas``, ``ROWS``) has no
  module in the port: its kernels K1/K2 live in ``ops/element_energy.py``
  with the gather fused (``element_energy``).  The ``ops`` package loads
  its exports on first use, since an eager import there is circular.
* Checkpoints (``utils.checkpoint``) are the port's own ``torch.save``
  format, ``ckpt_<step>.pt``, where the JAX package writes flax msgpack,
  ``ckpt_<step>.msgpack``: flax and msgpack may not be imported; the
  signatures are the JAX package's.
"""

import dataclasses
import importlib
import inspect

import pytest

# port module -> JAX module
MODULES = {
    "config": "config", "mesh.banded": "mesh.banded",
    "mesh.delaunay": "mesh.delaunay", "mesh.gmsh_backend":
    "mesh.gmsh_backend", "mesh.hybrid": "mesh.hybrid",
    "mesh.lattice": "mesh.lattice", "mesh.structured": "mesh.structured",
    "mesh.types": "mesh.types", "mesh.native": "mesh.native",
    "models.structured_grid": "models.structured_grid",
    "models.triangle_p1": "models.triangle_p1",
    "models.linear1d": "models.linear1d",
    "models.bilinear2d": "models.bilinear2d",
    "models.wrappers": "models.wrappers", "plots": "plots",
    "ops": "ops", "models": "models",
    "ops.assembly": "ops.assembly", "ops.banded_energy": "ops.banded_energy",
    "ops.elasticity": "ops.elasticity", "ops.lattice_energy":
    "ops.lattice_energy", "ops.lattice_slab": "ops.lattice_slab",
    "ops.losses": "ops.losses", "ops.quadrature": "ops.quadrature",
    "postproc": "postproc", "solve.drivers": "solve.drivers",
    "solve.optimizers": "solve.optimizers", "parallel": "parallel",
    "parallel.multihost": "parallel.multihost", "parallel.sharding":
    "parallel.sharding", "parallel.sharded_slab": "parallel.sharded_slab",
    "parallel.sharded_lattice": "parallel.sharded_lattice",
    "mesh": "mesh", "mesh.coloring": "mesh.coloring", "solve": "solve",
    "solve.linear": "solve.linear", "solve.nodespace": "solve.nodespace",
    "solve.multigrid": "solve.multigrid", "solve.auxspace": "solve.auxspace",
    "parallel.sharded_aux": "parallel.sharded_aux",
    "parallel.sharded_mg": "parallel.sharded_mg", "utils": "utils",
    "utils.profiling": "utils.profiling", "utils.checkpoint":
    "utils.checkpoint", "utils.metrics": "utils.metrics", "utils.debug":
    "utils.debug",
}

# JAX names the port does not have yet, by ROADMAP Queue A item (none:
# the port covers the whole JAX package)
NOT_YET_PORTED = {}
# JAX names with no torch counterpart by design (module doc)
NO_COUNTERPART = {"parallel.sharding": {"mesh_shardings"},
                  "parallel": {"mesh_shardings"}}

# parameters only the JAX package takes: (module, name) -> parameters
JAX_ONLY_PARAMS = {
    ("ops.banded_energy", "banded_element_energy"): {"interpret"},
    ("ops.lattice_slab", "lattice_total_slab"): {"interpret"},
    ("ops.lattice_slab", "structured_domain_slab"): {"interpret"},
    ("models.triangle_p1", "TriangleP1.init"): {"key"},
    ("models.structured_grid", "StructuredGridP1.init"): {"key"},
    ("mesh.lattice", "LatticeRoute"): {
        "fw_rel", "fw_starts", "bw_rel", "bw_starts", "ck_fwd_rowA",
        "ck_fwd_off", "ck_fwd_live", "ck_fwd_fix_rows", "ck_fwd_fix_idx",
        "ck_bwd_rowA", "ck_bwd_off", "ck_bwd_fix_rows", "ck_bwd_fix_idx",
        "ck_k", "fw_width", "bw_width"},
    ("models.bilinear2d", "Bilinear2D.init"): {"key"},
    ("models.bilinear2d", "Bilinear2D.create"): {"seed"},
    ("models", "TriangleP1.init"): {"key"},
    ("models", "StructuredGridP1.init"): {"key"},
    ("models", "Bilinear2D.init"): {"key"},
    ("models", "Bilinear2D.create"): {"seed"},
    ("models.wrappers", "PiecewiseLinearShapeNN2DStructured"): {"seed"},
    ("models.wrappers", "PiecewiseLinearShapeNN2D"): {"seed"},
}
# public methods only the JAX package has (none)
JAX_ONLY_METHODS = {}
# keyword parameters the port adds (module doc)
PORT_EXTRA_PARAMS = {"device", "dtype"}
PORT_EXTRA = {
    ("models.triangle_p1", "TriangleP1.init"): {"generator"},
    ("models.structured_grid", "StructuredGridP1.init"): {"generator"},
    ("models.bilinear2d", "Bilinear2D.init"): {"generator"},
    ("models.bilinear2d", "Bilinear2D.create"): {"generator"},
    ("models.wrappers", "PiecewiseLinearShapeNN2DStructured"): {
        "generator"},
    ("models.wrappers", "PiecewiseLinearShapeNN2D"): {"generator"},
    ("models.structured_grid", "StructuredGridP1"): {"backend"},
    ("models", "TriangleP1.init"): {"generator"},
    ("models", "StructuredGridP1.init"): {"generator"},
    ("models", "Bilinear2D.init"): {"generator"},
    ("models", "Bilinear2D.create"): {"generator"},
    ("models", "StructuredGridP1"): {"backend"},
    ("ops.banded_energy", "banded_element_energy"): {"row_start"},
    ("parallel.multihost", "initialize_multihost"): {"backend"},
    ("parallel", "initialize_multihost"): {"backend"},
    ("solve.drivers", "run_optimizer"): {"tol"},
    ("solve", "run_optimizer"): {"tol"},
}


def _params(obj):
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _check_params(mod, name, jax_obj, port_obj):
    pj, pp = _params(jax_obj), _params(port_obj)
    if pj is None or pp is None:
        return
    pj = [p for p in pj if p not in JAX_ONLY_PARAMS.get((mod, name), ())]
    extra = PORT_EXTRA_PARAMS | PORT_EXTRA.get((mod, name), set())
    kept = [p for p in pp if p not in extra or p in pj]
    assert kept == pj, f"{mod}.{name}: port {pp} vs JAX {pj}"


def _pairs():
    for mod, jmod in MODULES.items():
        yield pytest.param(mod, jmod, id=mod)


@pytest.mark.parametrize("mod,jmod", _pairs())
def test_port_module_matches_jax_surface(mod, jmod):
    jm = importlib.import_module("hidenn_fem_tpu." + jmod)
    pm = importlib.import_module("hidenn_fem_tpu_torch." + mod)
    names = getattr(jm, "__all__", None) or [
        n for n in dir(jm) if not n.startswith("_")
        and getattr(getattr(jm, n), "__module__", "").startswith(
            "hidenn_fem_tpu.")]
    skip = NOT_YET_PORTED.get(mod, set()) | NO_COUNTERPART.get(mod, set())
    missing = sorted(n for n in names if n not in skip
                     and not hasattr(pm, n))
    assert not missing, f"{mod} lacks {missing}"
    for n in names:
        if n in skip:
            assert not hasattr(pm, n) or n in NO_COUNTERPART.get(mod, ()), \
                f"{mod}.{n} is ported: take it off the list"
            continue
        j, p = getattr(jm, n), getattr(pm, n)
        if callable(j):
            _check_params(mod, n, j, p)
        if inspect.isclass(j) and inspect.isclass(p):
            if dataclasses.is_dataclass(j):
                fj = [f.name for f in dataclasses.fields(j)
                      if f.name not in JAX_ONLY_PARAMS.get((mod, n), ())]
                extra = PORT_EXTRA.get((mod, n), set())
                assert [f.name for f in dataclasses.fields(p)
                        if f.name not in extra] == fj, n
            no = JAX_ONLY_METHODS.get((mod, n), set())
            for m in vars(j):
                member = getattr(j, m)
                if m.startswith("_") or not callable(member) or m in no:
                    continue
                assert hasattr(p, m), f"{mod}.{n} lacks {m}"
                _check_params(mod, f"{n}.{m}", member, getattr(p, m))
            for m in no:
                assert not hasattr(p, m), f"{mod}.{n}.{m} is ported"


def test_device_mesh_is_a_descriptor_without_a_device_fallback():
    """``device_mesh`` without a group is this process alone, and without
    ``device`` it names the card (no CPU fallback)."""
    import torch

    from hidenn_fem_tpu_torch.parallel import DeviceMesh, device_mesh

    dm = device_mesh()
    assert isinstance(dm, DeviceMesh)
    assert (dm.rank, dm.size, dm.axis) == (0, 1, "elem")
    assert dm.device.type == "cuda"
    assert device_mesh(1, device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError, match="ranks"):
        device_mesh(4)
    with pytest.raises(dataclasses.FrozenInstanceError):
        dm.rank = 1
