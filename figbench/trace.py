"""The traced window of a ``--trace 1`` run and the arithmetic on its events.

`Capture` runs `torch.profiler` (host and device activities) around the
window and hands back the device's activities (kernels, copies, memsets) as
plain ``(name, start_ns, end_ns)`` tuples on the host's `time.perf_counter_ns`
clock, the clock of the benchmark's own host spans: a `record_function`
marker taken beside a `perf_counter_ns` reading at the start ties the two
clocks together. The profiler's own ranges on the device (user annotations
such as the port's ``figaro.r0_assembly``) and graph bookkeeping (``Command
Buffer``) are not activities and are left out.

The functions below take such tuples, so they run on a synthetic event list
as well as on a trace.
"""

from __future__ import annotations

import collections
import time

__all__ = ["Capture", "merged", "busy_ns", "in_window", "gaps",
           "label_gaps", "breakdown"]

_MARK = "figbench.clock"


class Capture:
    """``with Capture() as cap: ...``; then ``cap.device`` is the list of
    device activities and ``cap.offset_ns`` the trace clock minus the
    perf_counter clock."""

    def __init__(self):
        self.device: list = []
        self.offset_ns = 0

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.__enter__()
        t0 = time.perf_counter_ns()
        with record_function(_MARK):
            pass
        t1 = time.perf_counter_ns()
        self._mark_at = (t0 + t1) // 2
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self) -> None:
        from torch.autograd import DeviceType

        raw = _raw_events(self._prof)
        notes = {name for name, dev, _, _, note in raw
                 if dev != DeviceType.CUDA and note}
        mark = [s for name, dev, s, _, _ in raw
                if name == _MARK and dev != DeviceType.CUDA]
        self.offset_ns = (mark[0] - self._mark_at) if mark else 0
        off = self.offset_ns
        self.device = [(name, s - off, e - off)
                       for name, dev, s, e, note in raw
                       if dev == DeviceType.CUDA and not note
                       and name not in notes
                       and not name.startswith("Command Buffer")]


def _raw_events(prof) -> list:
    """(name, device type, start ns, end ns, is an annotation) of every
    event of a finished profile, on the trace's clock."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type(), start,
                    start + e.duration_ns(), bool(e.is_user_annotation())))
    return out


def in_window(events, w0: int, w1: int) -> list:
    """Events clipped to [w0, w1], the empty ones dropped."""
    out = []
    for name, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            out.append((name, s, e))
    return out


def merged(events) -> list:
    """The union of the events' intervals as sorted, disjoint [s, e]."""
    out: list = []
    for s, e in sorted((s, e) for _, s, e in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_ns(events) -> int:
    """Time in which at least one activity ran on the device."""
    return sum(e - s for s, e in merged(events))


def gaps(events, w0: int, w1: int) -> list:
    """The idle intervals of [w0, w1]: no activity ran on the device."""
    out, at = [], w0
    for s, e in merged(in_window(events, w0, w1)):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if w1 > at:
        out.append((at, w1))
    return out


def label_gaps(idle, spans) -> list:
    """(label, ns) of each idle interval: the names of the host spans that
    cover its midpoint, joined by ``+`` (``host.other`` where none does)."""
    out = []
    for s, e in idle:
        mid = (s + e) // 2
        names = sorted({n for n, a, b in spans if a <= mid < b})
        out.append(("+".join(names) or "host.other", e - s))
    return out


def breakdown(events, w0: int, w1: int, spans, top: int = 10) -> dict:
    """The device operations that took most time in [w0, w1], by name, and
    the longest idle gaps, each named by what the host was doing: at most
    ``top`` of each, in seconds."""
    by_name: collections.Counter = collections.Counter()
    for name, s, e in in_window(events, w0, w1):
        by_name[name] += e - s
    ops = [[name[:160], ns / 1e9] for name, ns in by_name.most_common(top)]
    idle = sorted(label_gaps(gaps(events, w0, w1), spans),
                  key=lambda x: -x[1])[:top]
    return {"device_ops": ops,
            "idle_gaps": [[label, ns / 1e9] for label, ns in idle]}
