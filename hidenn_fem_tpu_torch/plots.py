"""Visualization (port of ``hidenn_fem_tpu/plots.py``; needs matplotlib).

matplotlib is imported here, and the package's ``__init__`` never imports
this module, so ``import hidenn_fem_tpu_torch`` works on a machine without
matplotlib.  The Agg backend is selected when there is no display.  Every
function takes ``save_path``, returns the Figure, and shows it only when
asked; the device math comes from ``postproc.py`` and the models, and the
tensors are moved to host numpy for drawing.  Material constants are
arguments.
"""

from __future__ import annotations

import os

import matplotlib

if not os.environ.get("DISPLAY"):
    matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from . import postproc  # noqa: E402
from .mesh.types import TriMesh  # noqa: E402

__all__ = [
    "plot_fem_solution",
    "plot_fem_derivative",
    "plot_2d_solution",
    "plot_2d_derivatives",
    "plot_mesh",
    "plot_model_mesh",
    "plot_displacement_magnitude",
    "plot_von_mises",
]


def _np(t) -> np.ndarray:
    """Host numpy of a tensor (any device) or an array-like."""
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _finish(fig, save_path, show):
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return fig


def _device(params):
    return next(iter(params.values())).device


def plot_fem_solution(model, params, u_exact=None, title="FEM Solution",
                      n_eval=1000, save_path=None, show=False):
    """1D solution against the exact one."""
    grid = _np(model.grid(params))
    x = np.linspace(grid[0], grid[-1], n_eval)
    u = _np(model.apply(params, torch.tensor(x, dtype=model.dtype,
                                             device=_device(params))))
    fig = plt.figure(figsize=(8, 5))
    plt.plot(x, u, label="FEM solution", color="blue")
    if u_exact is not None:
        plt.plot(x, np.asarray(u_exact(x)), "--", label="Exact solution",
                 color="red")
    plt.xlabel("x")
    plt.ylabel("u(x)")
    plt.title(title)
    plt.legend()
    plt.grid(True)
    return _finish(fig, save_path, show)


def plot_fem_derivative(model, params, u_exact=None,
                        title="FEM Derivative du/dx", save_path=None,
                        show=False):
    """1D staircase derivative plot (one batched per-element recovery)."""
    du = _np(postproc.derivative_1d_per_element(model, params))
    grid = _np(model.grid(params))
    x_plot, y_plot = [], []
    for i in range(len(du)):
        x_plot.extend([grid[i], grid[i + 1]])
        y_plot.extend([du[i], du[i]])
    fig = plt.figure(figsize=(8, 5))
    plt.plot(x_plot, y_plot, label="FEM derivative", color="green")
    if u_exact is not None:
        plt.plot(grid, np.asarray(u_exact(grid)), "--",
                 label="Exact derivative", color="orange")
    plt.xlabel("x")
    plt.ylabel("du/dx")
    plt.title(title)
    plt.legend()
    plt.grid(True)
    return _finish(fig, save_path, show)


def _eval_grid(model, params, n_eval):
    gx, gy = (_np(g) for g in model.grid(params))
    X = np.linspace(gx[0], gx[-1], n_eval)
    Y = np.linspace(gy[0], gy[-1], n_eval)
    XX, YY = np.meshgrid(X, Y, indexing="ij")
    XY = torch.tensor(np.stack([XX.ravel(), YY.ravel()], axis=1),
                      dtype=model.dtype, device=_device(params))
    return XX, YY, XY


def plot_2d_solution(model, params, u_exact=None, n_eval=100,
                     save_path=None, show=False):
    """Structured-model 3D surface."""
    XX, YY, XY = _eval_grid(model, params, n_eval)
    U = _np(model.apply(params, XY)).reshape(n_eval, n_eval)
    fig = plt.figure(figsize=(8, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.plot_surface(XX, YY, U, cmap="viridis", alpha=0.8)
    if u_exact is not None:
        ax.plot_surface(XX, YY, np.asarray(u_exact(XX, YY)),
                        cmap="coolwarm", alpha=0.5)
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_zlabel("u(x,y)")
    plt.title("2D Piecewise Linear FEM Approximation")
    return _finish(fig, save_path, show)


def plot_2d_derivatives(model, params, n_eval=50, title="FEM Derivatives",
                        save_path=None, show=False):
    """Structured-model derivative surfaces (one batched derivative)."""
    XX, YY, XY = _eval_grid(model, params, n_eval)
    d = _np(model.grad_u(params, XY))
    du_dx = d[:, 0].reshape(n_eval, n_eval)
    du_dy = d[:, 1].reshape(n_eval, n_eval)
    fig = plt.figure(figsize=(14, 6))
    ax1 = fig.add_subplot(121, projection="3d")
    ax1.plot_surface(XX, YY, du_dx, cmap="viridis", alpha=0.8)
    ax1.set_title("du/dx")
    ax1.set_xlabel("x")
    ax1.set_ylabel("y")
    ax2 = fig.add_subplot(122, projection="3d")
    ax2.plot_surface(XX, YY, du_dy, cmap="viridis", alpha=0.8)
    ax2.set_title("du/dy")
    ax2.set_xlabel("x")
    ax2.set_ylabel("y")
    plt.suptitle(title)
    return _finish(fig, save_path, show)


def _mesh_overlay(pts, mesh: TriMesh, neumann_nodes: bool):
    cells = _np(mesh.connectivity)
    geom = _np(mesh.geom_boundary_mask)
    bc = _np(mesh.dirichlet_mask)
    edges = _np(mesh.neumann_edges)
    fig = plt.figure(figsize=(8, 4))
    plt.triplot(pts[:, 0], pts[:, 1], cells, color="blue", linewidth=0.3,
                alpha=0.6)
    plt.scatter(pts[geom, 0], pts[geom, 1], color="black", s=10, alpha=0.7,
                label="Geom Boundary")
    plt.scatter(pts[bc, 0], pts[bc, 1], color="red", s=15, label="Dirichlet")
    if neumann_nodes:
        mn = _np(mesh.neumann_mask)
        plt.scatter(pts[mn, 0], pts[mn, 1], color="purple", s=20,
                    label="Neumann Nodes")
    for e in edges:
        plt.plot(pts[e, 0], pts[e, 1], color="purple", linewidth=1.5,
                 alpha=0.9)
    plt.gca().set_aspect("equal")
    plt.axis("off")
    plt.tight_layout()
    return fig


def plot_mesh(mesh: TriMesh, save_path=None, show=False):
    """Mesh and boundary-condition overview."""
    return _finish(_mesh_overlay(_np(mesh.coords), mesh, True), save_path,
                   show)


def plot_model_mesh(model, params, mesh: TriMesh, save_path=None,
                    show=False):
    """Current (adapted) mesh with the boundary-condition overlays."""
    pts = _np(model.coords(params, mesh))
    return _finish(_mesh_overlay(pts, mesh, False), save_path, show)


def plot_displacement_magnitude(model, params, mesh: TriMesh,
                                save_path=None, show=False):
    """tripcolor of the per-element mean ||u||."""
    pts = _np(model.coords(params, mesh))
    cells = _np(mesh.connectivity)
    _, tri_vals = postproc.displacement_magnitude(model, params, mesh)
    fig = plt.figure(figsize=(8, 4))
    plt.tripcolor(pts[:, 0], pts[:, 1], cells, facecolors=_np(tri_vals),
                  edgecolors="k", cmap="viridis")
    plt.colorbar(label="Displacement magnitude ||u||")
    plt.xlabel("x [m]")
    plt.ylabel("y [m]")
    plt.title("HiDeNN displacement field (magnitude)")
    plt.gca().set_aspect("equal")
    return _finish(fig, save_path, show)


def plot_von_mises(model, params, mesh: TriMesh, E=10e9, nu=0.3,
                   save_path=None, show=False):
    """tripcolor of the per-element von Mises stress."""
    pts = _np(model.coords(params, mesh))
    cells = _np(mesh.connectivity)
    vm = _np(postproc.von_mises_per_element(model, params, mesh, E, nu))
    fig = plt.figure(figsize=(8, 4))
    plt.tripcolor(pts[:, 0], pts[:, 1], cells, facecolors=vm,
                  edgecolors="b", linewidth=0.2, cmap="inferno")
    plt.colorbar(label="Von Mises stress [Pa]")
    plt.xlabel("x [m]")
    plt.ylabel("y [m]")
    plt.title("HiDeNN von Mises stress concentration")
    plt.gca().set_aspect("equal")
    return _finish(fig, save_path, show)
