"""torch.profiler over the traced calls, reduced in memory (no trace
file is written): the device's operations by name, its busy time
inside the traced window, and its idle gaps named by what the host was
doing."""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import torch

#: what the idle gaps inside a call, outside any torch operation, are
#: named (the program's own Python: the tracing issue's spans would
#: name it)
HOST_CODE = "host code outside torch operations"


def start():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


@dataclass
class Summary:
    device: list = field(default_factory=list)  # (name, start_ns, dur_ns)
    host: list = field(default_factory=list)    # (name, start_ns, dur_ns)
    calls: list = field(default_factory=list)   # (start_ns, end_ns)

    @property
    def window_ns(self):
        if not self.calls:
            return None
        return self.calls[0][0], max(e for _, e in self.calls)

    def busy_intervals(self):
        """The union of device activity, clipped to the window."""
        lo, hi = self.window_ns
        spans = sorted((max(s, lo), min(s + d, hi))
                       for _, s, d in self.device if s < hi and s + d > lo)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def window_s(self) -> float:
        lo, hi = self.window_ns
        return (hi - lo) / 1e9

    def device_ops(self, top=10):
        tot = {}
        for name, _, d in self.device:
            tot[name] = tot.get(name, 0) + d
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, d / 1e9] for n, d in ranked]

    def idle_gaps(self, top=10):
        """The device's idle gaps inside the window, each named by the
        innermost host operation running at its middle, summed by name:
        a torch operation, a CUDA runtime call, the call's own code
        outside any torch operation, or the time between calls."""
        lo, hi = self.window_ns
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        host = sorted(self.host, key=lambda h: h[1])
        running = []   # heap of (end, duration, name) begun by the middle
        i, tot = 0, {}
        for s, e in zip(edges[::2], edges[1::2]):
            if e <= s:
                continue
            mid = (s + e) // 2
            while i < len(host) and host[i][1] <= mid:
                name, hs, hd = host[i]
                heapq.heappush(running, (hs + hd, hd, name))
                i += 1
            while running and running[0][0] < mid:
                heapq.heappop(running)
            name = (min(running, key=lambda r: r[1])[2] if running
                    else "between calls")
            tot[name] = tot.get(name, 0) + (e - s)
        ranked = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n, d / 1e9] for n, d in ranked]

    def count(self, part: str) -> int:
        return sum(1 for n, _, _ in self.device if part in n)

    def seconds(self, part: str) -> float:
        return sum(d for n, _, d in self.device if part in n) / 1e9


def stop(prof) -> Summary:
    """Close the profiler and keep what the readers need."""
    from .cell import CALL_SPAN
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    s = Summary()
    for ev in prof.profiler.kineto_results.events():
        name, t0, d = ev.name(), ev.start_ns(), ev.duration_ns()
        annotation = name == CALL_SPAN or (
            hasattr(ev, "is_user_annotation") and ev.is_user_annotation())
        if str(ev.device_type()).endswith("CUDA"):
            # kernels, memcpys and memsets; an annotation's projection
            # onto the device's timeline is no work
            if not annotation:
                s.device.append((name, t0, d))
        elif name == CALL_SPAN:
            s.calls.append((t0, t0 + d))
            s.host.append((HOST_CODE, t0, d))
        else:
            s.host.append((name, t0, d))
    s.calls.sort()
    return s


def ops_per_call(t: Summary):
    """Device operations per traced call, or None."""
    if not t or not t.calls or not t.device:
        return None
    return len(t.device) / len(t.calls)


def idle_share(t: Summary):
    """The device's idle share of the traced window in %, or None."""
    if not t or not t.calls or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s() / t.window_s())
