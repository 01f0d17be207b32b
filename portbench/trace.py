"""The device trace of a ``--trace 1`` run, reduced to what the metric
readers need: device intervals, host operations, and the window they are
read over.

The idle arithmetic is a copy of the port's own profiling tool
(``tools/profile_port.py``: idle = 1 - device busy / wall), with one
change: busy time is the union of the device intervals, not the sum of
their lengths, so that operations on several streams that overlap are not
counted twice.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Tuple

# Host calls that wait for the device (the ``.item()`` and ``.cpu()`` copies
# end in a stream synchronize; cuSOLVER's info copies in a plain cudaMemcpy).
HOST_BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy")
REQUEST_SPAN = "portbench.request"


@dataclass
class Event:
    name: str
    start: float        # microseconds, the profiler's clock
    end: float

    @property
    def length(self) -> float:
        return self.end - self.start


@dataclass
class Trace:
    window: Tuple[float, float]                     # first request start, last request end (us)
    device: List[Event] = field(default_factory=list)
    host: List[Event] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, clipped to the window."""
        w0, w1 = self.window
        spans = sorted((max(e.start, w0), min(e.end, w1)) for e in self.device
                       if e.end > w0 and e.start < w1)
        merged: List[Tuple[float, float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                if b > merged[-1][1]:
                    merged[-1] = (merged[-1][0], b)
            else:
                merged.append((a, b))
        return merged

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        w0, w1 = self.window
        gaps, t = [], w0
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        return gaps

    def host_at(self, t: float) -> str:
        """The innermost host operation under way at ``t``."""
        best = None
        for e in self.host:
            if e.start <= t <= e.end and (best is None or e.start > best.start
                                          or (e.start == best.start and e.end < best.end)):
                best = e
        return best.name if best is not None else "(no host operation)"

    def in_window(self, events):
        w0, w1 = self.window
        return [e for e in events if e.start >= w0 and e.end <= w1]

    def device_time_s(self, match) -> Tuple[float, int]:
        """Total seconds and count of the device operations whose name
        ``match(name)`` accepts."""
        hits = [e for e in self.in_window(self.device) if match(e.name)]
        return sum(e.length for e in hits) / 1e6, len(hits)

    def busy_during_s(self, name: str) -> Tuple[float, int]:
        """Seconds in which the device was busy while a host operation
        ``name`` was under way, and how many such operations ran (those that
        overlap counted once).  For an operation that waits for its own
        kernels, as cuSOLVER's ``eigh`` does, this is its device time."""
        spans: List[Tuple[float, float]] = []
        for e in sorted(self.in_window(self.host), key=lambda e: e.start):
            if e.name != name:
                continue
            if spans and e.start < spans[-1][1]:
                spans[-1] = (spans[-1][0], max(spans[-1][1], e.end))
            else:
                spans.append((e.start, e.end))
        busy = self.busy_intervals()
        starts = [a for a, _ in busy]
        total = 0.0
        for start, end in spans:
            i = max(bisect.bisect_right(starts, start) - 1, 0)
            while i < len(busy) and busy[i][0] < end:
                total += max(0.0, min(busy[i][1], end) - max(busy[i][0], start))
                i += 1
        return total / 1e6, len(spans)

    def host_count(self, names) -> int:
        return sum(1 for e in self.in_window(self.host) if e.name in names)

    def breakdown(self, top: int = 10):
        """The device operations that took most time and the longest idle
        gaps, each named by the host's operation at its middle."""
        by_name = {}
        for e in self.in_window(self.device):
            by_name[e.name] = by_name.get(e.name, 0.0) + e.length / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[name, s] for name, s in ops],
                "idle_gaps": [[self.host_at(0.5 * (a + b)), (b - a) / 1e6] for a, b in gaps]}


def from_profiler(prof) -> Trace:
    """Read a finished ``torch.profiler.profile`` (CPU and CUDA activities)
    whose requests ran under :data:`REQUEST_SPAN` spans."""
    from torch.autograd import DeviceType

    device, host, spans = [], [], []
    for e in prof.events():
        ev = Event(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a span's image on the device's timeline is not device work
            if not (e.is_user_annotation or e.name.startswith("portbench.")):
                device.append(ev)
        elif e.name == REQUEST_SPAN:
            spans.append(ev)
        else:
            host.append(ev)
    if not spans:
        raise RuntimeError("the trace holds no request span")
    return Trace((min(s.start for s in spans), max(s.end for s in spans)), device, host)
