"""Tracing and timing helpers (port of
``hidenn_fem_tpu/utils/profiling.py``).

* ``annotate`` and ``Span``: the port's one span primitive, a
  ``record_function`` range named ``hidenn.<layer>.<phase>`` (or
  ``hidenn.<entry point>`` for a solve's root), entered only while a
  profiler runs: with none, a span costs one read of
  ``torch.autograd._profiler_enabled()``.  ``torch.profiler`` puts the
  ranges in its kineto trace, on the clock of the device's activities;
  under ``torch.autograd.profiler.emit_nvtx()`` every ``record_function``
  is an NVTX range, for nsys.  ``annotate(name)`` is a ``with`` block;
  a ``Span`` may also be opened in one call and closed in a later one
  (``solve/loop.py``'s replay span);
* ``trace_to``: ``torch.profiler`` (CPU and, with a card, CUDA
  activities) over the enclosed block, its Chrome trace written into a
  directory;
* ``sync_time``: best-of wall time of one call, ended by a device
  synchronize and one scalar fetch;
* ``slope_time_scan``: the JAX package's slope method.  ``step_fn`` runs
  ``n1`` and then ``n2`` times in a Python loop, each run ending in a
  device synchronize and one scalar fetch, and the per-step time is
  ``(t2 - t1) / (n2 - n1)``: what a run costs once (launch latency of
  the first step, the final synchronize and read) cancels.  The JAX
  package compiles each run into one ``lax.scan``; here each step is
  dispatched from the host, so the slope is the step's host-or-device
  time, whichever bounds it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import (ProfilerActivity, profile, record_function,
                            tensorboard_trace_handler)

__all__ = ["annotate", "Span", "trace_to", "slope_time_scan", "sync_time"]


class Span:
    """A ``record_function`` range named ``name``, entered by ``open()``
    only while a profiler runs and left by ``close()``, in this call or a
    later one on the same thread (inner spans close first); also a
    ``with`` block.  ``close()`` of a span that is not open does
    nothing."""

    __slots__ = ("name", "_range")

    def __init__(self, name: str):
        self.name, self._range = name, None

    def open(self) -> None:
        if self._range is None and _profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()

    def close(self) -> None:
        if self._range is not None:
            r, self._range = self._range, None
            r.__exit__(None, None, None)

    def __enter__(self) -> "Span":
        self.open()
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def annotate(name: str) -> Span:
    """Named scope visible in profiler traces: ``with annotate(name):``
    (module doc)."""
    return Span(name)


@contextlib.contextmanager
def trace_to(logdir: str):
    """Profile the enclosed block (CPU activities, and CUDA ones when a
    card is present) and write its Chrome trace into ``logdir`` (one
    ``*.pt.trace.json`` file a block); yields the profiler."""
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for o in out:
            t = _first_tensor(o)
            if t is not None:
                return t
    return None


def _sync(out) -> None:
    """Wait for ``out``: synchronize its device, then fetch one scalar of
    its first tensor (the JAX package's guard against asynchronous
    backends that return before the work ends)."""
    leaf = _first_tensor(out)
    if leaf is None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        return
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)
    if leaf.numel():
        leaf.reshape(-1)[0].item()


def sync_time(fn: Callable, *args, repeats: int = 3) -> float:
    """Best-of wall time of ``fn(*args)`` with device sync (seconds)."""
    _sync(fn(*args))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def slope_time_scan(step_fn: Callable, init, n1: int = 50, n2: int = 550,
                    repeats: int = 3, args: tuple = ()) -> float:
    """Per-iteration time of ``step_fn`` by slope timing (seconds).

    Runs ``step_fn`` ``n1`` and ``n2`` times from ``init`` and returns
    (t2 - t1) / (n2 - n1), each t the best of ``repeats`` runs: costs a
    run pays once cancel exactly.

    ``step_fn(carry, *args) -> (carry, scalar)``; the last scalar is
    fetched to end each run.  Pass loop-invariant data (meshes, tables)
    through ``args``, not inside the carry, as the production drivers
    take it (``loss_args``).
    """
    def run(iters):
        c, val = init, None
        for _ in range(iters):
            c, val = step_fn(c, *args)
        _sync(val)

    run(n1)
    run(n2)

    def t(iters):
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(iters)
            best = min(best, time.perf_counter() - t0)
        return best

    return (t(n2) - t(n1)) / (n2 - n1)
