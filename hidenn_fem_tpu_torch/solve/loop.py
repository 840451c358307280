"""The one-program loop shared by the drivers and the linear solvers: a
body run eagerly or, on the card, recorded once in a CUDA graph and
replayed (the PyTorch counterpart of the JAX package's compiled
``lax.scan`` and ``lax.while_loop``).

``Replayer`` runs a body that updates static tensors in place.  On the
card its first ``eager`` calls run eagerly, the last of them (the
warm-up) on a side stream under ``torch.cuda.set_sync_debug_mode
("error")``, so a body that reads the device from the host, or copies
from pageable host memory, raises there; the next call records the body
once (``CUDAGraph.capture_begin``/``capture_end`` on the side stream,
without the ``torch.cuda.graph`` context's synchronize and cache flush,
with Python's garbage collector paused) and replays it, and every later
call is one replay.  The host launches one graph a call instead of the
body's tens to hundreds of kernels.  The
kernels' launch counters (and the collective counters of
``parallel.sharding``) count each replay: the launches recorded at
capture, times the replays (``settle``).  ``captures`` counts the graphs
recorded, the host seconds spent recording them, and the graphs freed
(their ``CUDAGraph`` destroyed, which gives their pool back): recorded
minus freed is how many graphs the process still holds.

Spans (``utils/profiling.annotate``, entered only while a profiler runs):
``hidenn.loop.eager`` around an eager call (the warm-up included),
``hidenn.loop.record`` around a recording (the graph's pool allocated in
it), one ``hidenn.loop.replay`` from a ``Replayer``'s first replay to
the next ``settle``, over every replay between, and
``hidenn.loop.flag_read`` around each read of a stop flag
(``read_flag``).  No span is recorded inside a captured body (it would
run once, at recording) or around a single replay.

``while_loop`` is JAX's ``lax.while_loop`` for a body that masks itself:
the body computes the loop condition on the device into a flag, and a
call on a false flag changes no carried tensor (bit for bit), so calls
past the stop are harmless.  The host reads the flag before the first
call and then once every ``READ_EVERY`` calls, never once a kernel.
A loop makes its own ``Replayer`` (one warm-up and one recording a
loop), or runs one it is given: a solver that keeps its carried tensors
across solves (``multigrid``'s plan) keeps its ``Replayer`` too, and
every loop after the one that recorded only replays.

``READ_EVERY = 4``.  A read costs the device its idle time while the
host waits and launches the next replay, tens of µs; a call past the
stop costs one masked iteration of device time, 0.05-0.3 ms for CG and
about 2 ms for an MG-PCG or aux-PCG iteration at ~900K nodes, and a solve
runs (READ_EVERY - 1) / 2 of them on average.  At 4, a 200-iteration
CG solve makes 50 reads and a 15-iteration MG-PCG solve wastes 1.5
iterations on average.  ``chip_smoke.py`` phase 23 times 1, 2, 4 and 8
on every solver: on an H100 the 898K-element CG solve is fastest at 4
and 8 and 9-12% slower at 1, and on the other solvers the periods lie
within the spread between runs (PERF.md section 6).

Not captured, each decided before the first call from a stated fact
(the same body then runs eagerly, the ``READ_EVERY`` structure
included):
* tensors on the CPU: CUDA graphs exist only on the card;
* a process whose default ``torch.distributed`` group runs on gloo (the
  sharded paths with several ranks on one card): gloo's collectives run
  on the host and cannot be recorded; NCCL ranks are captured;
* a solve allowed fewer than ``MIN_CAPTURED`` = 3 iterations: its first
  iteration is the eager warm-up and recording costs about one more
  eager iteration of host time, so fewer than two replays cannot pay
  for it.
A body that makes a host sync, or a capture that fails, raises: no path
falls back to the eager loop.
"""

from __future__ import annotations

import contextlib
import gc
import time
import weakref

import torch

from ..utils.profiling import Span, annotate

__all__ = ["READ_EVERY", "MIN_CAPTURED", "Replayer", "while_loop",
           "read_flag", "capturable", "captures"]

READ_EVERY = 4
MIN_CAPTURED = 3

# graphs recorded since the last reset, the host seconds it took, and
# the graphs among them since destroyed
captures = {"graphs": 0, "seconds": 0.0, "freed": 0}


def _freed() -> None:
    captures["freed"] += 1


def read_flag(flag: torch.Tensor) -> bool:
    """The host's read of a device stop flag (a wait for the device), in
    a ``hidenn.loop.flag_read`` span."""
    with annotate("hidenn.loop.flag_read"):
        return bool(flag)


def _counters() -> tuple:
    """The kernels' launch counters, the energy routes' counter and the
    collective counters, which a replay must move as the captured calls
    did."""
    from ..ops import banded_energy, element_energy, lattice_slab, \
        lbfgs_history, losses, window_gather
    from ..parallel import sharding
    return (element_energy.launch_counts, lattice_slab.launch_counts,
            banded_energy.launch_counts, window_gather.launch_counts,
            lbfgs_history.launch_counts, losses.route_counts,
            sharding.collective_counts)


def capturable(device: torch.device) -> bool:
    """Whether a body on ``device`` is captured: on the card, unless the
    default process group runs on gloo (module doc)."""
    if device.type != "cuda":
        return False
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()
                and dist.get_backend() == "gloo")


@contextlib.contextmanager
def _no_host_sync():
    """``set_sync_debug_mode("error")`` over the block: a body that waits
    for the device from the host raises, with what it means here."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    except RuntimeError as e:
        raise RuntimeError(
            "the loop body (an optimizer step or a solver iteration) "
            "synchronizes with the host (a read of a device value, a copy "
            "from pageable memory), so it cannot be captured in a CUDA "
            "graph; see solve/loop.py") from e
    finally:
        torch.cuda.set_sync_debug_mode(mode)


class Replayer:
    """``body()`` (in-place updates of static tensors): eager, or with
    ``capture`` its first ``eager`` calls eager (the last one the
    warm-up), then one CUDA graph replayed a call (module doc)."""

    def __init__(self, body, device: torch.device, capture: bool,
                 eager: int = 1):
        self.body, self.device = body, device
        self.capture, self.eager = capture, eager
        self.calls = self.replays = 0
        self.graph = self.side = self.per_replay = None
        self._replaying = Span("hidenn.loop.replay")

    def _warm_up(self):
        cur = torch.cuda.current_stream(self.device)
        self.side = torch.cuda.Stream(self.device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side), _no_host_sync():
            out = self.body()
        cur.wait_stream(self.side)
        return out

    def _capture(self):
        counters = _counters()
        before = [dict(c) for c in counters]
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        # a garbage collection while recording could destroy another graph
        # (one held in a reference cycle), which the capture forbids
        collecting = gc.isenabled()
        gc.disable()
        try:
            with annotate("hidenn.loop.record"), \
                    torch.cuda.stream(self.side):
                graph.capture_begin()
                try:
                    self.body()     # recorded, not run: the state stands
                finally:
                    graph.capture_end()
        finally:
            if collecting:
                gc.enable()
        captures["graphs"] += 1
        weakref.finalize(graph, _freed).atexit = False
        captures["seconds"] += time.perf_counter() - t0
        self.per_replay = [{k: c[k] - b[k] for k in c}
                           for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.update(b)
        self.graph = graph

    def __call__(self):
        """One call of the body: returns its result when it ran eagerly,
        None when it was a replay."""
        if self.graph is None and self.capture and self.calls >= self.eager:
            self._capture()
        self.calls += 1
        if self.graph is not None:
            if not self.replays:
                self._replaying.open()
            self.graph.replay()
            self.replays += 1
            return None
        with annotate("hidenn.loop.eager"):
            if self.capture and self.calls == self.eager:
                return self._warm_up()
            return self.body()

    def settle(self) -> int:
        """Move the counters by the replays since the last ``settle``,
        close their span, and return how many there were."""
        self._replaying.close()
        n, self.replays = self.replays, 0
        if n:
            for c, d in zip(_counters(), self.per_replay):
                for k, v in d.items():
                    c[k] += v * n
        return n


def while_loop(body, active: torch.Tensor, max_iters: int,
               device: torch.device) -> None:
    """Call ``body`` while the device flag ``active`` holds, at most
    ``max_iters`` times; the body keeps ``active`` current and changes
    nothing once it is false.  The host reads ``active`` before the first
    call and after every ``READ_EVERY`` calls (module doc).  ``body`` is a
    function, run by a ``Replayer`` made for this loop, or a ``Replayer``
    kept across loops."""
    loop = body if isinstance(body, Replayer) else Replayer(
        body, device, capturable(device) and max_iters >= MIN_CAPTURED)
    done = 0
    while done < max_iters and read_flag(active):
        n = min(READ_EVERY, max_iters - done)
        for _ in range(n):
            loop()
        done += n
    loop.settle()
