"""Example 5 on the port (``examples/example5_scaling_torch.py``) against
the JAX package's ``examples/example5_scaling.py`` at 41x21 nodes.

Both packages take the same route on the plate: ``generate_mesh`` drops
the hole nodes, so both detect a renumbered lattice and run the plain
lattice route (the stencil kernels take identity-numbered lattices only),
with no banded tables at this size.  From JAX's own PRNGKey(0) init
(carried across as numpy), the port's warm L-BFGS history equals JAX's at
rtol 1e-4 at init, after the first step and at the plateau after 200
steps (measured 1.3e-6 there).  Between them the fixed step's first jump
(to ~2e10) amplifies f32 rounding (the two paths part by up to 7% where
the energy crosses zero and meet again at the plateau), so the path is not
compared entry by entry (ROADMAP Queue C, convention 5).
"""

import jax
import numpy as np
import pytest

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from examples import example5_scaling as jex5
from examples import example5_scaling_torch as tex5

from torch_port_common import CPU

NX, NY, STEPS = 41, 21, 200


def test_example5_takes_the_jax_route():
    jm = ht.generate_mesh(length=2.0, height=1.0, holes=tex5.HOLES, nx=NX,
                          ny=NY)
    tm = pt.generate_mesh(length=2.0, height=1.0, holes=tex5.HOLES, nx=NX,
                          ny=NY, device=CPU)
    np.testing.assert_array_equal(tm.coords.numpy(), np.asarray(jm.coords))
    assert jm.lattice is not None and tm.lattice is not None
    assert not jm.lattice.identity and not tm.lattice.identity
    assert jm.banded is None and tm.banded is None \
        and tm.banded_paired is None
    jp = ht.TriangleP1().init(jax.random.PRNGKey(0), jm)
    tp = pt.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device=CPU)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1(u_fixed=0.0), E=10e9,
                              nu=0.3)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(u_fixed=0.0), E=10e9,
                              nu=0.3)
    assert je._lattice_total(jp, jm) is not None
    assert te._lattice_total(tp, tm) is not None
    assert np.isclose(float(te.total(tp, tm)), float(je.total(jp, jm)),
                      rtol=1e-5)


def test_example5_matches_jax(capsys):
    _, jl = jex5.main(nx=NX, ny=NY, lbfgs_steps=STEPS)
    jl = np.asarray(jl)
    jm = ht.generate_mesh(length=2.0, height=1.0, holes=tex5.HOLES, nx=NX,
                          ny=NY)
    u0 = np.asarray(ht.TriangleP1().init(jax.random.PRNGKey(0), jm)["u"])
    params, tl = tex5.main(nx=NX, ny=NY, lbfgs_steps=STEPS, device="cpu",
                           u0=u0)
    out = capsys.readouterr().out
    assert "qp/s [cpu]" in out and "reference CPU baseline" in out
    assert tl.shape == (STEPS,) and np.all(np.isfinite(tl))
    assert set(params) == {"coords", "u"}
    for i in (0, 1, -1):
        assert np.isclose(tl[i], jl[i], rtol=1e-4), (i, tl[i], jl[i])


def test_example5_on_two_ranks():
    """Launched as 2 ranks (``torch.distributed.run``, gloo on the CPU),
    the example joins the group, shards the element axis and runs; both
    ranks start from the same energy as the one-process run (the
    element-sharded gather route against the lattice route, printed to 5
    digits) and print the same L-BFGS energies."""
    import os
    import re
    import subprocess
    import sys

    from torch_sharded_common import free_port

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node",
         "2", "--master_port", str(free_port()), "-m",
         "examples.example5_scaling_torch", "--device", "cpu", "--nx",
         str(NX), "--ny", str(NY), "--steps", "5"],
        cwd=root, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("sharded over 2 ranks") == 2
    cold = re.findall(r"energy (\S+) -> (\S+) \[cpu\]", out.stdout)
    assert len(cold) == 2 and cold[0] == cold[1]
    _, losses = tex5.main(nx=NX, ny=NY, lbfgs_steps=5, device="cpu")
    assert float(cold[0][0]) == float(f"{losses[0]:.4e}")
