"""One run of one cell: set-up, the measured window, the trace, the check.

The loop is closed, with one client: an engineer's script that submits a
solve, waits for its answer and submits the next, every solve a new load
case from the seed (``fembench/traffic.py``).  The window runs whole
solves back to back through the port's public entry point (the cell's
driver, ``fembench/drivers/<driver>.py``) and ends with the first solve
that finishes after ``seconds``; each solve's host clock ends in
``torch.cuda.synchronize()``.  With ``trace`` the profiler covers the
window's first ``trace_solves`` solves (the traffic file's), and the run
reports the per-layer metrics instead of the end-to-end ones.

After the window: the peak of device memory is read (the metric's at
the window's ``mem_solves``-th solve, the traffic file's), the driver reads
what the port has to say about the checked solves, the port's state is
freed, and the plain reference judges the checked solves on the card
(``fembench/reference``), each number against the cell's limit
(``fembench/limits/<workload>.json``).
"""

from __future__ import annotations

import gc
import os
import sys
import time
from contextlib import contextmanager

import torch
from torch.profiler import record_function

from . import spec, traffic as traffic_gen
from .trace import SOLVE_SPAN, Window

def process_age_s() -> float | None:
    """Seconds since this process started (Linux), or None."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


class Phases:
    """Host seconds of the named set-up phases, each ended by a
    synchronize of the card."""

    def __init__(self, device):
        self.device, self.seconds = device, {}

    @contextmanager
    def __call__(self, name):
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.seconds[name] = (self.seconds.get(name, 0.0)
                              + time.perf_counter() - t0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, imports_s: float = 0.0,
             overrides: dict | None = None) -> dict:
    """The result of one run (module doc).  ``overrides`` replaces entries
    of the configuration's ``mesh`` (the CPU tests' small sizes)."""
    device = torch.device(device)
    cell = spec.workload(bench, workload)
    cfg = spec.config(bench, cell["config"])
    if overrides:
        cfg = dict(cfg, mesh=dict(cfg["mesh"], **overrides))
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(workload)
    phases = Phases(device)
    phases.seconds["imports"] = imports_s

    if device.type == "cuda":
        with phases("cuda_init"):
            torch.zeros((), device=device)
        torch.cuda.reset_peak_memory_stats(device)
    driver = spec.module("drivers", mix["driver"]).Driver(cfg, mix, device)
    driver.setup(phases)
    with phases("warmup"):
        for case in traffic_gen.warmup_cases(mix, seed):
            driver.solve(case)
    gc.collect()
    _sync(device)
    age = process_age_s()
    setup_s = (age if age is not None
               else sum(phases.seconds.values()))

    # the window
    cases = traffic_gen.load_cases(mix, seed)
    checked = traffic_gen.sampled(mix, seed)
    n_traced = int(mix["trace_solves"]) if trace else 0
    # the window runs at least ``mem_solves`` solves, and peak_mem_gib is
    # the peak over set-up and those: a solve's state outlives it until
    # Python's cyclic collector runs (PERF.md section 7), so the peak over
    # a whole window moves with the solves that fit into it.  (A CPU run
    # reads no device memory.)
    n_mem = int(mix["mem_solves"]) if device.type == "cuda" else 0
    peak_mem = 0
    window = Window() if trace else None
    kept, times, traced, last = [], [], [], None
    counters0 = None
    t_start = time.perf_counter()
    while True:
        if window is not None and len(times) == 0:
            counters0 = driver.counters()
            window.start()
        case = next(cases)
        t0 = time.perf_counter()
        with record_function(SOLVE_SPAN):
            out = driver.solve(case)
            _sync(device)
        t1 = time.perf_counter()
        times.append(t1 - t0)
        if len(times) <= n_traced:
            traced.append(out)
            if len(times) == n_traced:
                window.stop()
                counters1 = driver.counters()
        if next(checked):
            kept.append(driver.keep(out))
            last = None
        else:
            last = out
        if len(times) == n_mem:
            peak_mem = torch.cuda.max_memory_allocated(device)
        if t1 - t_start >= seconds and len(times) >= max(n_traced, n_mem):
            break
    window_s = time.perf_counter() - t_start
    if last is not None:
        kept.append(driver.keep(last))
    del out, last

    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    run = Run(times, window_s, peak_mem, setup_s, phases.seconds)
    if trace:
        run.traced(driver, traced, window.summary(),
                   {k: counters1[k] - counters0.get(k, 0)
                    for k in counters1})
        del window
    metrics = {}
    for m in spec.metrics_for(bench, workload,
                              "per_layer" if trace else "end_to_end"):
        value = spec.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"attempted": len(times)}

    # the check: the port's own readings first, then its state is freed
    driver.program_readings(kept)
    driver.release()
    del driver
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = judge(mix, cfg, kept, device)
    checks = {k: {"value": v, "limit": float(limits[k]["limit"])}
              for k, v in numbers["worst"].items()}
    correct = bool(kept) and all(c["value"] <= c["limit"]
                                 for c in checks.values())
    failed = sum(not all(n[k] <= checks[k]["limit"] for k in checks)
                 for n in numbers["each"])

    result.update(correct=correct, failed=failed, metrics=metrics)
    result["device"] = device_info(device, peak)
    if trace:
        result["device"].update(busy_s=run.trace.busy_s,
                                window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["setup_split_s"] = dict(phases.seconds)
    result["checked_solves"] = len(kept)
    result["checks"] = checks
    log("set-up split (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in phases.seconds.items()))
    log(f"checked {len(kept)} of {len(times)} solves; numbers compared:")
    for k, c in checks.items():
        log(f"  {k} {c['value']:.6g} limit {c['limit']:.6g}")
    return result


def judge(mix: dict, cfg: dict, kept: list, device) -> dict:
    """Each checked solve's numbers from the reference, and the worst of
    each over them."""
    each = spec.module("drivers", mix["driver"]).judge(cfg, mix, kept,
                                                        device)
    worst = {k: max(n[k] for n in each) for k in each[0]} if each else {}
    return {"each": each, "worst": worst}


def device_info(device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}


class Run:
    """What a metric's reader reads (``fembench/metrics/<name>.py``): the
    window (its length, each solve's wall time), the peak of device
    memory, the set-up (its length and phases) and, in the traced run,
    the traced solves (the driver's outcomes), the trace's summary, the
    port's launch counters over them, their steps and iterations, and
    their work by kernel family (bytes, counted from the shapes)."""

    def __init__(self, times, window_s, peak_bytes, setup_s, setup):
        self.times, self.window_s = times, window_s
        self.peak_bytes, self.setup_s, self.setup = peak_bytes, setup_s, setup
        self.solves, self.trace, self.counters = [], None, {}
        self.steps = self.iterations = 0
        self.work = {}

    def traced(self, driver, solves, summary, counters):
        self.solves, self.trace, self.counters = solves, summary, counters
        self.steps = sum(driver.steps(o) for o in solves)
        self.iterations = sum(driver.iterations(o) for o in solves)
        self.work = driver.work(solves)
