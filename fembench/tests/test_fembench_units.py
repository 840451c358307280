"""CPU tests of the benchmark's parts: the frozen mesh recipes against the
port's, the plain reference against the port's plain route, the roofline
byte counts against the port's kernel table, the look-up by name, the
traffic generator, the shape of BENCHMARK.json and of a result line, and
the import rule.  Run: ``python -m pytest fembench/tests -q``.
"""

from __future__ import annotations

import ast
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from fembench import harness, roofline, spec, traffic
from fembench.meshes import plate_holes, structured_grid
from fembench.reference.grid_plate import grid_plate
from fembench.reference.p1_plate import P1Plate
from fembench.reference.precision import Precision, round_tf32

CPU = torch.device("cpu")
HOLES = [[0.5, 0.7, 0.12], [1.0, 0.3, 0.15], [1.4, 0.6, 0.1]]
FACES = {"up": 0, "down": 0, "right": 2, "left": 1}
BENCH = spec.benchmark()
SMALL = {"plate3h_922k": {"nx": 41, "ny": 21},
         "grid_961x481": {"nx": 33, "ny": 17}}


def plate_cfg(nx=61, ny=31, keep=True, variant="zigzag"):
    return dict(kind="plate_holes", length=2.0, height=1.0, holes=HOLES,
                nx=nx, ny=ny, variant=variant, keep_dead_nodes=keep,
                boundaries=FACES)


@pytest.mark.parametrize("keep", [True, False])
@pytest.mark.parametrize("variant", ["zigzag", "up"])
def test_plate_recipe_matches_the_port(keep, variant, monkeypatch):
    import hidenn_fem_tpu_torch as ht
    monkeypatch.setenv("HDNN_NO_NATIVE", "1")
    a = plate_holes.arrays(plate_cfg(keep=keep, variant=variant))
    m = ht.generate_mesh(2.0, 1.0, [tuple(h) for h in HOLES], FACES, 61, 31,
                         variant=variant, keep_dead_nodes=keep, device=CPU)
    for k, v in a.items():
        assert np.array_equal(v, getattr(m, k).numpy()), k


@pytest.mark.parametrize("holes", [[], [[1.0, 0.5, 0.2]]])
def test_grid_recipe_matches_the_port(holes):
    from hidenn_fem_tpu_torch.models.structured_grid import \
        generate_structured_grid
    a = structured_grid.arrays(dict(length=2.0, height=1.0, holes=holes,
                                    nx=33, ny=17, split="up",
                                    boundaries=FACES))
    g = generate_structured_grid(holes=[tuple(h) for h in holes], nx=33,
                                 ny=17, device=CPU)
    for k in ("coords", "geom_boundary_mask", "dirichlet_mask",
              "quad_mask"):
        assert np.array_equal(a[k], getattr(g, k).numpy()), k
    assert a["neumann_edge_masks"].keys() == g.neumann_edge_masks.keys()
    for f, mask in a["neumann_edge_masks"].items():
        assert np.array_equal(mask, g.neumann_edge_masks[f].numpy())


def _random_params(n, seed=0, dtype=torch.float64):
    gen = torch.Generator().manual_seed(seed)
    return (1e-3 * torch.randn((n, 2), generator=gen, dtype=dtype),
            1e-5 * torch.randn((n, 2), generator=gen, dtype=dtype))


def test_reference_energy_matches_the_port_plain_route():
    """float64, both gradient groups, at moved coordinates."""
    import hidenn_fem_tpu_torch as ht
    a = plate_holes.arrays(plate_cfg())
    mesh = ht.TriMesh.from_arrays(**a, dtype=torch.float64, device=CPU)
    model = ht.TriangleP1(dtype=torch.float64)
    energy = ht.PlaneStressEnergy(model=model, E=1e10, nu=0.3,
                                  F_total=8e4)
    dc, u = _random_params(mesh.n_nodes)
    p = {"coords": (mesh.coords + dc).requires_grad_(True),
         "u": u.clone().requires_grad_(True)}
    e = energy.total(p, mesh)
    gc, gu = torch.autograd.grad(e, [p["coords"], p["u"]])
    ref = P1Plate(a["coords"], a["connectivity"], a["geom_boundary_mask"],
                  a["dirichlet_mask"], a["neumann_edges"], 1e10, 0.3,
                  traction=(8e4, 0.0))
    re_, rgc, rgu = ref.value_and_grads(mesh.coords + dc, u)
    assert abs(float(e.detach()) - float(re_)) <= 1e-12 * abs(float(re_))
    for g, rg in ((gc, rgc), (gu, rgu)):
        assert torch.allclose(g, rg, rtol=1e-10, atol=1e-12 * rg.abs().max())


def test_reference_grid_matches_the_structured_model():
    """The grid as P1 triangles: energy, u-gradient, and the assembled
    stiffness against the gradient's differences."""
    import hidenn_fem_tpu_torch as ht
    from hidenn_fem_tpu_torch.models.structured_grid import StructuredGridP1
    a = structured_grid.arrays(dict(length=2.0, height=1.0,
                                    holes=[[1.0, 0.5, 0.2]], nx=33, ny=17,
                                    split="up", boundaries=FACES))
    grid = ht.grid_from_numpy(types.SimpleNamespace(**a), device=CPU,
                              dtype=torch.float64)
    t = (9e4, 2e4)
    model = StructuredGridP1(E=1e10, nu=0.3, dtype=torch.float64,
                             tractions={"right": t})
    _, u = _random_params(33 * 17)
    ul = u.view(33, 17, 2).clone().requires_grad_(True)
    e = model({"coords": grid.coords, "u": ul}, grid)
    (g,) = torch.autograd.grad(e, ul)
    ref = grid_plate(a, 1e10, 0.3, t)
    re_, _, rg = ref.value_and_grads(grid.coords.reshape(-1, 2), u)
    assert abs(float(e.detach()) - float(re_)) <= 1e-12 * abs(float(re_))
    assert torch.allclose(g.reshape(-1, 2), rg, rtol=1e-10,
                          atol=1e-12 * rg.abs().max())
    K, f, free = ref.stiffness()
    c = ref.coords0
    _, _, g0 = ref.value_and_grads(c, torch.zeros_like(c))
    ku = (K @ u.reshape(-1)[free][:, None])[:, 0]
    uf = torch.where(ref.dirichlet, 0.0, u)
    assert torch.allclose(ku, (rg - g0).reshape(-1)[free], rtol=1e-9,
                          atol=1e-9 * ku.abs().max())
    assert torch.allclose(f, -g0.reshape(-1)[free])
    assert torch.equal(uf.reshape(-1)[~free], torch.zeros(int((~free).sum()),
                                                          dtype=uf.dtype))


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12,
                      -3.0 - 2 ** -9 - 2 ** -11, 1.0 + 2 ** -12])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10,
                         -3.0 - 2 ** -9, 1.0])
    assert torch.equal(round_tf32(x), want)
    a = torch.randn(4, 5)
    b = torch.randn(5, 3)
    assert torch.equal(Precision("tf32").mm(a, b),
                       round_tf32(a) @ round_tf32(b))


def test_roofline_bytes_match_the_kernel_table():
    """PERF.md's kernel table: the dots pass 1,464.60 MB at the 898K
    plate (m = 100, P = 1,803,696), the combination 1,457.39 MB; K6 20.32
    MB on the 922K-class plate (its diagonal choice and two triangle
    masks)."""
    h = roofline.lbfgs_history_bytes(100, 1_803_696)
    assert round(h["dots"] / 1e6, 2) == 1464.60
    assert round(h["combine"] / 1e6, 2) == 1457.39
    assert round(roofline.stencil_vg_bytes(961, 481, 3) / 1e6, 2) == 20.32


def test_the_plate_has_the_stated_sizes():
    a = plate_holes.arrays(spec.config(BENCH, "plate3h_922k")["mesh"])
    assert a["connectivity"].shape[0] == 852_676
    assert a["coords"].shape[0] == 462_241


def test_parts_are_found_by_name():
    for cell in BENCH["workloads"]:
        cfg = spec.config(BENCH, cell["config"])
        mix = spec.traffic(cell["traffic"])
        mod = spec.module("drivers", mix["driver"])
        for name in ("Driver", "judge", "control"):
            assert hasattr(mod, name)
        assert hasattr(spec.module("meshes", cfg["mesh"]["kind"]), "arrays")
        assert spec.limits(cell["name"])
        for section in ("end_to_end", "per_layer"):
            for m in spec.metrics_for(BENCH, cell["name"], section):
                assert callable(spec.module("metrics", m["name"]).read)
    # a split quantity falls back to the reader of its name's first part
    assert (spec.module("metrics", "device_idle_share.any").read.__code__
            is not None)
    for name in ("no_such_metric", "no_such_metric.mg"):
        with pytest.raises(KeyError):
            spec.module("metrics", name)


def test_traffic_is_the_same_set_in_another_order():
    mix = spec.traffic("mg_loadcases")
    n = int(mix["pool"])

    def first(seed):
        cases = traffic.load_cases(mix, seed)
        return [next(cases) for _ in range(n)]

    a, b, a2 = first(2 ** 31 + 7), first(12), first(2 ** 31 + 7)
    assert a == a2
    key = sorted((c["magnitude"], c["angle_deg"]) for c in a)
    assert key == sorted((c["magnitude"], c["angle_deg"]) for c in b)
    assert [c["index"] for c in a] == list(range(n))
    assert a != b
    mags = [c["magnitude"] for c in a]
    assert 5e4 <= min(mags) and max(mags) <= 1.5e5
    assert all(abs(c["angle_deg"]) <= 30.0 for c in a)


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= b["run_seconds"] <= 51
    names = set()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(b["paths"][0] + "/")
        names.add(c["name"])
    cells = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] == 1
        assert len(w["why"]) <= 200
        cells.add(w["name"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = [e for e in b["end_to_end"] if e["name"] == m["moves"]][0]
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    for cell in cells:
        assert spec.metrics_for(b, cell, "per_layer")
        assert len(spec.metrics_for(b, cell, "end_to_end")) >= 2
    for name in cells | names:
        assert NAME.match(name)
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_prints_the_contract_keys(trace):
    cell = "plate3h_922k.lbfgs_m10"
    r = harness.run_cell(BENCH, cell, 2 ** 31 + 3, 0.0, trace, CPU,
                         overrides=SMALL["plate3h_922k"])
    want = ["correct", "attempted", "failed", "metrics", "device"]
    if trace:
        want.append("breakdown")
    assert set(want) <= set(r) and list(r)[-1] == "checks"
    assert set(r) - set(want) == {"setup_split_s", "checked_solves",
                                  "checks"}
    assert r["correct"] is True and r["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    reported = {m["name"] for m in spec.metrics_for(BENCH, cell, section)}
    assert set(r["metrics"]) <= reported
    if not trace:     # no device memory is read on the CPU
        assert set(r["metrics"]) == reported - {"peak_mem_gib"}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(r)


HERE = Path(spec.HERE)


def _top_level_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_and_the_reference_not_the_port():
    """Top-level names compared whole: ``hidenn_fem_tpu_torch`` starts
    with ``hidenn_fem_tpu``."""
    files = sorted(HERE.rglob("*.py"))
    assert files
    for path in files:
        names = _top_level_imports(path)
        assert not names & {"jax", "jaxlib", "flax", "hidenn_fem_tpu"}, path
        if "reference" in path.relative_to(HERE).parts:
            assert "hidenn_fem_tpu_torch" not in names, path
            assert "fembench" not in names, path
