"""The port's ``utils`` (checkpoint, metrics, debug, profiling) and
``solve_with_checkpointing``: the mirror of ``tests/test_utils_aux.py``'s
checkpoint, metrics and gradient-check cases and of
``tests/test_checkpoint_resume.py``, held to the JAX package where both
compute the same numbers.

* Checkpoints round-trip the params and every optimizer state of the port
  (Adam, frozen groups, compact, two-loop and zoom L-BFGS) into their
  templates bit for bit, and a resumed solve continues as an uninterrupted
  one; a wrong shape, a wrong file or a newer format raise.  The files are
  the port's own (``ckpt_<step>.pt``, ``torch.save``), not flax msgpack.
* Metrics: the per-group gradient norms and min |detJ| equal the JAX
  package's at rtol 1e-5 (f32).
* ``check_gradients``: the norms equal JAX's at rtol 1e-5, and in f64 the
  port's autograd gradient equals central differences of the loss along
  random directions at rtol 1e-6.
* ``solve_with_checkpointing``: a run "crashed" after 40 of 100 steps
  and resumed runs only the remaining 60 steps and ends bit-equal to an
  uninterrupted run (the port's loop repeats the same operations), whose
  losses are within rtol 1e-5 of the JAX package's chunked run.
* Profiling: ``sync_time`` and ``slope_time_scan`` give finite positive
  times on a toy step, and the slope cancels a cost paid once per run;
  ``trace_to`` writes a Chrome trace with an ``annotate`` range.
"""

import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hidenn_fem_tpu as ht
import hidenn_fem_tpu_torch as pt
from hidenn_fem_tpu.solve.drivers import \
    solve_with_checkpointing as jsolve_ckpt
from hidenn_fem_tpu.utils import check_gradients as jcheck_gradients
from hidenn_fem_tpu.utils import solve_metrics as jsolve_metrics
from hidenn_fem_tpu_torch.solve import optimizers as topt
from hidenn_fem_tpu_torch.solve.drivers import solve_with_checkpointing
from hidenn_fem_tpu_torch.utils import (MetricsWriter, StepTimer,
                                        annotate, assert_all_finite,
                                        check_gradients,
                                        enable_nan_debugging,
                                        latest_checkpoint,
                                        restore_checkpoint, save_checkpoint,
                                        slope_time_scan, solve_metrics,
                                        sync_time, trace_to)

from torch_port_common import CPU, port_mesh


def _plate(nx, ny, dtype=torch.float32):
    """(JAX mesh and params, port mesh, energy and params) of the proxy
    plate, JAX's PRNGKey(0) init carried across."""
    jm = ht.proxy_plate_mesh(nx=nx, ny=ny)
    jp = ht.TriangleP1().init(jax.random.PRNGKey(0), jm)
    tm = port_mesh(jm, dtype=dtype)
    tp = pt.params_from_numpy({k: np.asarray(v) for k, v in jp.items()},
                              device=CPU, dtype=dtype)
    te = pt.PlaneStressEnergy(model=pt.TriangleP1(dtype=dtype))
    return jm, jp, tm, te, tp


def _states(params):
    """(optimizer, state after 3 updates) of each optimizer of the port."""
    x = topt.ravel_params(params)
    g = torch.linspace(-1.0, 1.0, x.numel())
    out = {}
    for name, opt in (("adam", pt.adam(1e-3)),
                      ("frozen", pt.freeze_groups(pt.adam(1e-3),
                                                  ["coords"])),
                      ("compact", topt.lbfgs(memory_size=3)),
                      ("scan", topt.lbfgs(memory_size=3, mode="scan")),
                      ("zoom", topt.lbfgs(memory_size=3,
                                          linesearch="zoom"))):
        s = opt.init(x, like=params)
        y = x.clone()
        for i in range(3):
            if name == "zoom":
                step, s = opt.update(
                    g * (i + 1), s, y, value=torch.sum(y * y),
                    value_fn=lambda z: (torch.sum(z * z), 2 * z))
            else:
                step, s = opt.update(g * (i + 1), s, y)
            y = y + step
        out[name] = (opt, s)
    return out


def _assert_tree_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a, b)
    elif isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert type(a) is type(b) and a == b


def test_checkpoint_roundtrip(tmp_path):
    _, _, tm, te, params = _plate(5, 3)
    for name, (opt, state) in _states(params).items():
        path = str(tmp_path / f"ckpt_{name}.pt")
        save_checkpoint(path, params, state, step=40,
                        metadata={"note": name})
        p2, s2, step, meta = restore_checkpoint(path, params, state)
        assert step == 40 and meta["note"] == name
        _assert_tree_equal(p2, params)
        _assert_tree_equal(s2, state)
        # resume actually continues the solve
        x = topt.ravel_params(p2)
        if name != "zoom":
            opt.update(torch.ones_like(x), s2, x)
    raw_p, raw_s, _, _ = restore_checkpoint(path)
    assert set(raw_p) == {"coords", "u"} and "lbfgs" in raw_s


def test_checkpoint_rejects_wrong_shapes_and_files(tmp_path):
    _, _, _, _, params = _plate(5, 3)
    path = str(tmp_path / "ckpt_1.pt")
    save_checkpoint(path, params, step=1)
    bad = {"coords": params["coords"][:3], "u": params["u"]}
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(path, bad)
    other = str(tmp_path / "other.pt")
    torch.save({"x": torch.zeros(2)}, other)
    with pytest.raises(ValueError, match="not a hidenn_fem_tpu_torch"):
        restore_checkpoint(other)
    with open(other, "wb") as f:
        f.write(b"HDNNTPU1 msgpack bytes")
    with pytest.raises(ValueError, match="not a hidenn_fem_tpu_torch"):
        restore_checkpoint(other)
    payload = torch.load(path, weights_only=True)
    payload["version"] = 99
    torch.save(payload, other)
    with pytest.raises(ValueError, match="version"):
        restore_checkpoint(other)


def test_latest_checkpoint(tmp_path):
    d = str(tmp_path)
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    for s in (1, 30, 7):
        save_checkpoint(os.path.join(d, f"ckpt_{s}.pt"), {"x": 1.0}, step=s)
    open(os.path.join(d, "ckpt_99.msgpack"), "w").close()
    open(os.path.join(d, "ckpt_x.pt"), "w").close()
    assert latest_checkpoint(d).endswith("ckpt_30.pt")


def test_metrics_and_writer(tmp_path):
    jm, jp, tm, te, tp = _plate(5, 3)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1())
    jl, jg = jax.value_and_grad(lambda p: je(p, jm))(jp)
    want = jsolve_metrics(3, jl, jg, je.model, jp, jm, wall_per_step=0.01,
                          n_quad_points=256)
    p = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = te(p, tm)
    grads = dict(zip(sorted(p), torch.autograd.grad(loss, [p["coords"],
                                                         p["u"]])))
    m = solve_metrics(3, loss, grads, te.model, tp, tm, wall_per_step=0.01,
                      n_quad_points=256)
    assert sorted(m) == sorted(want)
    for k in ("loss", "grad_norm/u", "grad_norm/coords", "min_abs_detJ"):
        assert np.isclose(m[k], want[k], rtol=1e-5), k
    assert m["step"] == 3 and m["qp_evals_per_sec"] == 256 / 0.01
    path = str(tmp_path / "metrics.jsonl")
    with MetricsWriter(path) as w:
        w.write(m)
    with open(path) as f:
        assert json.loads(f.readline())["step"] == 3


def test_check_gradients_helper():
    jm, jp, tm, te, tp = _plate(5, 3)
    je = ht.PlaneStressEnergy(model=ht.TriangleP1())
    want = jcheck_gradients(lambda p: je(p, jm), jp, verbose=False)
    norms = check_gradients(lambda p: te(p, tm), tp, verbose=False)
    assert set(norms) == {"u", "coords"}
    for k in norms:
        assert np.isclose(norms[k], want[k], rtol=1e-5), k
    with pytest.raises(FloatingPointError, match=r"\['a'\]"):
        assert_all_finite({"a": torch.tensor([1.0, float("nan")])})
    with pytest.raises(FloatingPointError, match="loss is non-finite"):
        check_gradients(lambda p: p["u"].sum() * float("nan"), tp,
                        verbose=False)


def test_check_gradients_agrees_with_central_differences_f64():
    _, _, tm, te, tp = _plate(7, 4, torch.float64)
    p0 = {k: v.clone() for k, v in tp.items()}
    p0["coords"] = p0["coords"] + 1e-3 * torch.sin(
        torch.arange(p0["coords"].numel(), dtype=torch.float64)
    ).reshape(p0["coords"].shape)
    p0["u"] = 1e-4 * torch.cos(torch.arange(
        p0["u"].numel(), dtype=torch.float64)).reshape(p0["u"].shape)
    norms = check_gradients(lambda p: te(p, tm), p0, verbose=False)
    p = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
    grads = torch.autograd.grad(te(p, tm), [p["coords"], p["u"]])
    assert np.isclose(norms["u"], float(grads[1].norm()), rtol=1e-12)
    gen = torch.Generator().manual_seed(0)
    for key, g, h in (("coords", grads[0], 1e-6), ("u", grads[1], 1e-9)):
        for _ in range(3):
            d = torch.randn(g.shape, generator=gen, dtype=torch.float64)
            hi = {**p0, key: p0[key] + h * d}
            lo = {**p0, key: p0[key] - h * d}
            fd = (float(te(hi, tm)) - float(te(lo, tm))) / (2 * h)
            assert np.isclose(float((g * d).sum()), fd, rtol=1e-6), key


def test_enable_nan_debugging_toggles_anomaly_mode():
    try:
        enable_nan_debugging(True)
        assert torch.is_anomaly_enabled()
    finally:
        enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_resume_continues_from_latest(tmp_path):
    jm, jp, tm, te, tp = _plate(9, 5)
    loss = lambda p: te(p, tm)       # noqa: E731
    opt = pt.adam(1e-6)
    d = str(tmp_path / "a")

    # "crash" after 40 of 100 steps
    solve_with_checkpointing(loss, tp, opt, 40, d, checkpoint_every=20)
    assert sorted(os.listdir(d)) == ["ckpt_20.pt", "ckpt_40.pt"]

    # resume to 100: starts from step 40, not from scratch
    metrics = str(tmp_path / "metrics.jsonl")
    p_res, hist = solve_with_checkpointing(loss, tp, opt, 100, d,
                                           checkpoint_every=20,
                                           metrics_path=metrics,
                                           n_quad_points=4 * 64)
    assert os.path.exists(os.path.join(d, "ckpt_100.pt"))
    assert sum(len(h) for h in hist) == 60      # only the remaining steps
    with open(metrics) as f:
        lines = [json.loads(x) for x in f]
    assert [x["step"] for x in lines] == [60, 80, 100]
    assert all(x["qp_evals_per_sec"] > 0 for x in lines)

    # an uninterrupted run ends equal to the resumed one, bit for bit
    p_full, full = solve_with_checkpointing(loss, tp, opt, 100,
                                            str(tmp_path / "b"),
                                            checkpoint_every=20)
    for k in p_full:
        assert torch.equal(p_res[k], p_full[k]), k
    assert torch.equal(torch.cat(full[2:]), torch.cat(hist))

    # and follows the JAX package's chunked run
    je = ht.PlaneStressEnergy(model=ht.TriangleP1())
    _, jhist = jsolve_ckpt(lambda p: je(p, jm), jp, ht.adam(1e-6), 100,
                           str(tmp_path / "jax"), checkpoint_every=50)
    np.testing.assert_allclose(torch.cat(full).numpy(),
                               np.concatenate([np.asarray(h)
                                               for h in jhist]),
                               rtol=1e-5)


# ---------------------------------------------------------------- profiling
def test_sync_time_and_slope_time_scan_on_a_toy_step():
    x = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))

    def step(c, a):
        c = torch.tanh(c @ a)
        return c, c.sum()

    t = sync_time(lambda a: step(a, a), x, repeats=2)
    assert np.isfinite(t) and t > 0
    slope = slope_time_scan(step, x, n1=2, n2=12, repeats=2, args=(x,))
    assert np.isfinite(slope) and slope > 0


def test_slope_cancels_a_cost_paid_once_per_run():
    """A 60 ms cost on a run's first step, 3 ms on every step: the slope
    is the 3 ms, where the mean over a 5-step run is 15 ms."""
    def step(c):
        time.sleep(0.06 if c == 0 else 0.003)
        return c + 1, torch.tensor(float(c))

    slope = slope_time_scan(step, 0, n1=5, n2=25, repeats=2)
    assert 0.002 < slope < 0.006, slope


def test_trace_to_writes_a_chrome_trace_with_annotations(tmp_path):
    with trace_to(str(tmp_path)):
        with annotate("hdnn_annotated_block"):
            torch.ones(8).sum()
    files = [f for f in os.listdir(tmp_path) if f.endswith(".json")]
    assert len(files) == 1
    with open(tmp_path / files[0]) as f:
        assert "hdnn_annotated_block" in f.read()


def test_step_timer():
    t = StepTimer().start()
    out = torch.ones(4) * 2
    assert 0 <= t.stop(out, n_steps=4) < 1.0
