"""The traced run's window: ``torch.profiler`` (CPU and CUDA activities)
over a few whole solves, reduced to what the per-layer metrics read.

Copied from the port's ``tools/profile_torch_port.py`` (its
``device_window`` padding, the union of device intervals of ``_busy_ms``
and the short kernel names of ``kernel_us``), reading kineto's events
directly, which is much faster than building ``FunctionEvent`` trees.
kineto keeps only the device activities whose timestamps fall inside the
window by the host's clock, and the card's can lie off it, so the window
opens and closes with ``PAD_S`` of host time in which nothing launches.
"""

from __future__ import annotations

import bisect
import re
import time

import torch
from torch.profiler import ProfilerActivity, profile

PAD_S = 0.02
SPAN_PREFIX = "fembench."
SOLVE_SPAN = "fembench.solve"
_CUDA = torch.autograd.DeviceType.CUDA


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag and flag()) or e.name().startswith(SPAN_PREFIX)


def short_name(name: str) -> str:
    """A kernel's name without return type, namespaces, template
    arguments and parameters: ``dots_kernel``, ``stencil_vg_kernel``."""
    base = re.sub(r"^void\s+|\(anonymous namespace\)::", "",
                  name).split("(")[0]
    depth, out = 0, []
    for ch in base:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip().split("::")[-1].strip()


class Window:
    """Profile from ``start()`` to ``stop()``; ``summary()`` reduces it."""

    def __init__(self):
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def start(self):
        self.prof.__enter__()
        time.sleep(PAD_S)

    def stop(self):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(PAD_S)
        self.prof.__exit__(None, None, None)

    def summary(self) -> "Summary":
        """The window's device and host events, from the start of the
        first ``fembench.solve`` span to the end of the last."""
        events = self.prof.profiler.kineto_results.events()
        dev, cpu, spans = [], [], []
        for e in events:
            s, d = e.start_ns(), e.duration_ns()
            if e.device_type() == _CUDA:
                # the host's ranges are mirrored on the device's timeline
                # as annotations: not operations of the device
                if not _annotation(e):
                    dev.append((s, s + d, e.name()))
            elif e.name().startswith(SPAN_PREFIX):
                spans.append((s, s + d, e.name()))
            else:
                cpu.append((s, s + d, e.name()))
        solves = [sp for sp in spans if sp[2] == SOLVE_SPAN]
        return Summary(dev, cpu, spans, min(sp[0] for sp in solves),
                       max(sp[1] for sp in solves))


class Summary:
    """Device busy time, kernels by name, and the idle gaps labelled by
    what the host was doing, over [t0, t1]."""

    def __init__(self, dev, cpu, spans, t0_ns, t1_ns):
        self.t0, self.t1 = t0_ns, t1_ns
        dev = sorted(d for d in dev if d[1] > t0_ns and d[0] < t1_ns)
        self.n_device_ops = len(dev)
        self.by_name = {}
        for s, e, name in dev:
            k = short_name(name)
            self.by_name[k] = self.by_name.get(k, 0.0) + (e - s) * 1e-9
        merged = []
        for s, e, _ in dev:
            s, e = max(s, t0_ns), min(e, t1_ns)
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-9
        self.window_s = (t1_ns - t0_ns) * 1e-9
        edges = [t0_ns] + [x for iv in merged for x in iv] + [t1_ns]
        self._gaps = [(edges[i], edges[i + 1])
                      for i in range(0, len(edges), 2)
                      if edges[i + 1] > edges[i]]
        self._cpu = sorted(cpu)
        self._cpu_starts = [c[0] for c in self._cpu]
        self._spans = sorted(spans)
        self._span_starts = [c[0] for c in self._spans]

    def idle_share(self):
        """100 (1 - busy / window), or None with no device time."""
        if self.window_s <= 0 or self.busy_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, names) -> float:
        """Device seconds of the kernels with these short names."""
        return sum(self.by_name.get(n, 0.0) for n in names)

    def _inner(self, events, starts, t, scan=2000):
        """The latest-starting event of ``events`` that holds ``t``."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - scan, -1), -1):
            if events[j][1] >= t:
                return events[j][2]
        return None

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = {}
        for s, e in self._gaps:
            mid = (s + e) // 2
            span = self._inner(self._spans, self._span_starts, mid) or \
                "outside the benchmark's spans"
            op = self._inner(self._cpu, self._cpu_starts, mid) or \
                "no host op"
            label = f"{span} / {op}"
            gaps[label] = gaps.get(label, 0.0) + (e - s) * 1e-9
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}
