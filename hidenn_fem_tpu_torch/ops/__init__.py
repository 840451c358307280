"""ops layer of the PyTorch port: the names ``hidenn_fem_tpu.ops``
exports, each loaded from its module on first use (``ops.losses``
imports the models, whose modules import ``ops`` submodules, so an eager
import here would be circular).  The JAX package's ``ops.pallas_energy``
(``element_energy_pallas``, ``ROWS``) has no module of its own here: its
kernels K1/K2 live in ``ops/element_energy.py`` with the gather fused."""

import importlib

_EXPORTS = {
    "interval_gauss_points": "quadrature",
    "interval_gauss_points_m11": "quadrature",
    "triangle_gauss_points": "quadrature",
    "TRIANGLE_RULE_DEGREE": "quadrature",
    "plane_stress_C": "elasticity",
    "strain_voigt_from_grad": "elasticity",
    "stress_from_strain": "elasticity",
    "energy_density": "elasticity",
    "von_mises_plane_stress": "elasticity",
    "l2_loss": "losses",
    "bar_energy_1d": "losses",
    "PlaneStressEnergy": "losses",
}
__all__ = list(_EXPORTS)


def __getattr__(name):
    if name in _EXPORTS:
        module = importlib.import_module(f".{_EXPORTS[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
