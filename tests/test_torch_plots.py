"""The port's plots (``hidenn_fem_tpu_torch/plots.py``, matplotlib with
Agg) and examples 1-3 (``examples/example{1,2,3}_torch.py``) at small
size, beside the JAX package's; and the package without matplotlib.

The port half of ``tests/test_plots_and_examples.py``.  The examples run
at reduced size in both packages from the same configuration; examples 1
and 3 start from the same deterministic init in both, so their final
losses are held to JAX's (rtol 1e-3: f32 rounding carried through the
Adam steps); example 2's packages draw different minibatches, so its
histories are only finite and falling (its index-table run against JAX
is in ``tests/test_torch_bilinear2d.py``).
"""

import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu_torch import plots

from torch_port_common import CPU

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def outdir(tmp_path):
    yield str(tmp_path)
    import matplotlib.pyplot as plt
    plt.close("all")


def test_all_plot_functions(outdir):
    model, params = pt.Linear1D.from_node_coords(np.linspace(0, 1, 12),
                                                 device=CPU)
    params["u"] = torch.tensor(np.sin(np.linspace(0, 1, 12)),
                               dtype=torch.float32)
    plots.plot_fem_solution(model, params, u_exact=np.sin,
                            save_path=f"{outdir}/s1.png")
    plots.plot_fem_derivative(model, params, u_exact=np.cos,
                              save_path=f"{outdir}/d1.png")
    m2, p2 = pt.Bilinear2D.create(np.linspace(0, 1, 6),
                                  np.linspace(0, 1, 7), device=CPU)
    plots.plot_2d_solution(m2, p2, n_eval=12, save_path=f"{outdir}/s2.png")
    plots.plot_2d_derivatives(m2, p2, n_eval=8, save_path=f"{outdir}/d2.png")
    mesh = pt.proxy_plate_mesh(nx=7, ny=5, device=CPU)
    tp = pt.TriangleP1()
    pp = tp.init(torch.Generator().manual_seed(0), mesh, device=CPU)
    plots.plot_mesh(mesh, save_path=f"{outdir}/mesh.png")
    plots.plot_model_mesh(tp, pp, mesh, save_path=f"{outdir}/mm.png")
    plots.plot_displacement_magnitude(tp, pp, mesh,
                                      save_path=f"{outdir}/dm.png")
    fig = plots.plot_von_mises(tp, pp, mesh, save_path=f"{outdir}/vm.png")
    assert fig.axes
    for f in ("s1", "d1", "s2", "d2", "mesh", "mm", "dm", "vm"):
        assert os.path.getsize(f"{outdir}/{f}.png") > 0


def test_example1_small(outdir):
    from examples import example1, example1_torch
    from hidenn_fem_tpu.config import Projection1DConfig as J
    from hidenn_fem_tpu_torch.config import Projection1DConfig as T

    _, jl = example1.main(J(n_nodes=20, epochs=50), outdir=outdir)
    _, tl = example1_torch.main(T(n_nodes=20, epochs=50), outdir=outdir,
                                device=CPU)
    assert np.isfinite(tl).all() and tl[-1] < tl[0]
    np.testing.assert_allclose(tl[-1], np.asarray(jl)[-1], rtol=1e-3)
    assert os.path.getsize(f"{outdir}/example1_derivative.png") > 0


def test_example2_small(outdir):
    from examples import example2_torch
    from hidenn_fem_tpu_torch.config import Projection2DConfig

    _, _, losses, mse = example2_torch.main(
        Projection2DConfig(nx=8, ny=8, n_train_1d=20, batch_size=64,
                           epochs=50), outdir=outdir, device=CPU)
    assert np.isfinite(losses).all() and np.isfinite(mse)
    assert losses[-10:].mean() < losses[:10].mean()
    assert os.path.getsize(f"{outdir}/example2_solution.png") > 0


def test_example3_small(outdir):
    from examples import example3, example3_torch
    from hidenn_fem_tpu.config import Bar1DConfig as J
    from hidenn_fem_tpu_torch.config import Bar1DConfig as T

    _, jl, jerr = example3.main(J(n_nodes=25, epochs=200), outdir=outdir)
    _, tl, err = example3_torch.main(T(n_nodes=25, epochs=200),
                                     outdir=outdir, device=CPU)
    assert np.isfinite(err) and np.isfinite(tl).all()
    np.testing.assert_allclose(tl[-1], np.asarray(jl)[-1], rtol=1e-3)
    np.testing.assert_allclose(err, jerr, rtol=1e-2)
    assert os.path.getsize(f"{outdir}/example3_solution.png") > 0


def test_configs_match_jax():
    from hidenn_fem_tpu import config as jc
    from hidenn_fem_tpu_torch import config as tc

    for name in ("Projection1DConfig", "Projection2DConfig",
                 "Bar1DConfig", "PlateConfig"):
        assert vars(getattr(tc, name)()) == vars(getattr(jc, name)()), name


def test_package_and_examples_import_without_matplotlib(tmp_path):
    """With matplotlib unimportable the package and examples 1-3 import,
    and the examples run without drawing."""
    script = textwrap.dedent(f"""
        import sys
        sys.modules["matplotlib"] = None
        import torch
        import hidenn_fem_tpu_torch
        from examples import example1_torch, example2_torch, example3_torch
        from hidenn_fem_tpu_torch.config import Projection1DConfig
        assert example1_torch.plots_module() is None
        _, losses = example1_torch.main(Projection1DConfig(n_nodes=8,
                                                           epochs=3),
                                        outdir={str(tmp_path)!r},
                                        device=torch.device("cpu"))
        assert len(losses) == 3
        try:
            import hidenn_fem_tpu_torch.plots
        except ImportError:
            pass
        else:
            raise AssertionError("plots imported without matplotlib")
    """)
    subprocess.run([sys.executable, "-c", script], check=True, cwd=ROOT)
    assert not os.listdir(tmp_path)


def test_plots_follow_the_jax_figures(outdir):
    """The same figure layout as the JAX package's for the same model:
    axes count, titles and labels (1D and triangular)."""
    from hidenn_fem_tpu import plots as jplots

    jm, jp = ht.Linear1D.from_node_coords(np.linspace(0, 1, 12))
    tm, tp = pt.Linear1D.from_node_coords(np.linspace(0, 1, 12), device=CPU)
    jf = jplots.plot_fem_derivative(jm, jp, title="t")
    tf = plots.plot_fem_derivative(tm, tp, title="t")
    assert len(jf.axes) == len(tf.axes)
    for a, b in zip(jf.axes, tf.axes):
        assert (a.get_title(), a.get_xlabel(), a.get_ylabel()) == \
            (b.get_title(), b.get_xlabel(), b.get_ylabel())
    mesh_j = ht.proxy_plate_mesh(nx=7, ny=5)
    mesh_t = pt.proxy_plate_mesh(nx=7, ny=5, device=CPU)
    jf = jplots.plot_von_mises(ht.TriangleP1(), ht.TriangleP1().init(
        jax.random.PRNGKey(0), mesh_j), mesh_j)
    tf = plots.plot_von_mises(pt.TriangleP1(), pt.TriangleP1().init(
        torch.Generator().manual_seed(0), mesh_t, device=CPU), mesh_t)
    assert [a.get_label() for a in jf.axes] == \
        [a.get_label() for a in tf.axes]
