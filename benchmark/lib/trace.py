"""The device trace of a window: torch.profiler's events reduced to the
device's busy time (the union of its operations' intervals, so that
overlapping streams count once), each kernel's launches and device time,
and the device's idle time by what the host was doing meanwhile."""

from __future__ import annotations

import collections
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


def union_length(intervals: List[Tuple[int, int]]) -> int:
    """Total length covered by [start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """The holes between the union of [start, end) intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out


@dataclass
class Trace:
    """What a traced window's device did, in nanoseconds."""

    busy_ns: int = 0
    kernels: Dict[str, List[int]] = field(default_factory=dict)  # name -> durations
    top_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)  # by host op

    def launches(self, kernel: str) -> Tuple[int, float]:
        """(launches, device seconds) of the kernels whose name holds
        `kernel` as a whole word."""
        n, ns = 0, 0
        word = re.compile(rf"\b{re.escape(kernel)}\b")
        for name, durs in self.kernels.items():
            if word.search(name):
                n += len(durs)
                ns += sum(durs)
        return n, ns / 1e9


def device_ops(events) -> list:
    """The kernels, copies and sets among the trace's device events: the
    device's mirror of a host annotation (same name) is left out, and where
    events tell their activity, only the device activities are kept."""
    from torch.autograd import DeviceType

    host_names = {e.name() for e in events
                  if e.device_type() == DeviceType.CPU}
    out = []
    for e in events:
        if e.device_type() == DeviceType.CPU or e.name() in host_names:
            continue
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type()).lower()
            if (not any(k in kind for k in DEVICE_ACTIVITIES)
                    or "annotation" in kind):
                continue
        out.append(e)
    return out


def reduce_profile(prof, top: int = 10) -> Trace:
    """Reduce a finished torch.profiler.profile over the window."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    device = device_ops(events)
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.device_type() == DeviceType.CPU and e.duration_ns() > 0]
    intervals = [(e.start_ns(), e.end_ns()) for e in device]
    kernels: Dict[str, List[int]] = collections.defaultdict(list)
    for e in device:
        kernels[e.name()].append(e.duration_ns())
    by_time = sorted(((n, sum(d) / 1e9) for n, d in kernels.items()),
                     key=lambda x: -x[1])[:top]
    return Trace(busy_ns=union_length(intervals), kernels=dict(kernels),
                 top_ops=by_time,
                 idle_gaps=idle_by_host(gaps(intervals), host)[:top])


def idle_by_host(holes: List[Tuple[int, int]],
                 host: List[Tuple[int, int, str]]) -> List[Tuple[str, float]]:
    """The device's idle seconds by what the host was doing: each gap goes
    to the innermost host event that covers its middle ("host idle" where
    none does), summed by that event's name, longest first."""
    if not holes:
        return []
    mids = np.array([(s + e) // 2 for s, e in holes], np.int64)
    order = np.argsort(mids)
    mids = mids[order]
    lengths = np.array([e - s for s, e in holes], np.int64)[order]
    best = np.full(len(mids), np.iinfo(np.int64).max, np.int64)
    owner = np.full(len(mids), -1, np.int64)
    names = []
    for s, e, name in host:
        lo, hi = np.searchsorted(mids, s), np.searchsorted(mids, e)
        if lo == hi:
            continue
        seg = best[lo:hi]
        inner = seg > e - s
        if inner.any():
            seg[inner] = e - s
            owner[lo:hi][inner] = len(names)
            names.append(name)
    totals: Dict[str, float] = collections.defaultdict(float)
    for o, n in zip(owner, lengths):
        totals[names[o] if o >= 0 else "host idle"] += float(n) / 1e9
    return sorted(totals.items(), key=lambda x: -x[1])
