"""The port's instrumentation and the shared pieces of the profiling entry
points (profile_serve, profile_train).

Spans and counters inside the program, recorded only while a
torch.profiler is recording (the benchmark's traced run, profile_serve,
profile_train); otherwise each call is one check of the profiler's flag:

- `span(name)`: a context manager around one layer's call. It opens a
  `torch.profiler.record_function(name)`, so that the span sits in the
  profiler's trace as a host event, keeps the host start and end
  (`time.time_ns()`, the clock of the profiler's host events), and on a
  process that uses CUDA records a timing event on the current stream at
  entry and at exit. A span takes its parent from the spans open on its
  thread; one without a parent starts a request (a `serve.render`, a
  `serve.load_scene`, a `train.step`), whose id its descendants share. A
  span that opens on another thread, such as autograd's, has no parent.
- `count(name, n=1)`: adds n to a counter.
- `take_report()`: the spans and counters recorded since the last report,
  which it then clears. Call it after a device synchronize.

Stream ms is the time from the stream reaching a span's entry marker to
its reaching the exit marker: the device's work queued inside the span,
and any time the stream waited for the host meanwhile. Self time is a
span's duration less the part of it that its child spans cover.

Beside them, the operator and kernel tables of a torch.profiler run by
device time, and the card's name and power limit.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

# what span() returns while no profiler records: one shared, reusable
# context that does nothing
_OFF = contextlib.nullcontext()


@dataclass
class SpanRecord:
    """One finished span. Stream times are ms on the clock of the first
    span's entry marker on the same device, filled in by take_report."""

    id: int
    name: str
    parent: Optional[int]
    request: int
    thread: int
    host_start_ns: int
    host_end_ns: int = 0
    device: Optional[int] = None
    stream_start_ms: Optional[float] = None
    stream_end_ms: Optional[float] = None


class _Span:
    __slots__ = ("_recorder", "_name", "_rf", "_rec", "_events")

    def __init__(self, recorder: "Recorder", name: str):
        self._recorder, self._name = recorder, name

    def __enter__(self):
        rec = self._recorder
        stack = rec._stack()
        parent = stack[-1]._rec if stack else None
        self._rf = torch.profiler.record_function(self._name)
        self._rf.__enter__()
        start_ns = time.time_ns()
        rec._begin()
        self._rec = SpanRecord(
            id=next(rec._ids), name=self._name,
            parent=None if parent is None else parent.id,
            request=next(rec._requests) if parent is None else parent.request,
            thread=threading.get_ident(), host_start_ns=start_ns)
        self._events = None
        if torch.cuda.is_initialized():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
            self._events = (start, torch.cuda.Event(enable_timing=True))
            self._rec.device = torch.cuda.current_device()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record()
        self._rec.host_end_ns = time.time_ns()
        self._recorder._stack().pop()
        self._rf.__exit__(*exc)
        self._recorder._finish(self._rec, self._events)
        return False


class Recorder:
    """The spans and counters of one recorded period: from the first span
    or count after a report to the next report. Thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count(1)
        self._requests = itertools.count(1)
        self._reset()

    def _reset(self):
        self._done: list = []
        self._counters: Dict[str, int] = {}
        self._launches0: Optional[Dict[str, int]] = None

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _begin(self):
        if self._launches0 is None:
            with self._lock:
                if self._launches0 is None:
                    self._launches0 = kernel_launches()

    def _finish(self, rec: SpanRecord, events):
        with self._lock:
            self._done.append((rec, events))

    def count(self, name: str, n: int = 1) -> None:
        self._begin()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def take_report(self) -> dict:
        """{"spans": summarize()'s table, "counters": {name: n},
        "kernel_launches": {kernel: launches in the period},
        "records": [SpanRecord]}; then clears the period."""
        with self._lock:
            done, counters, launches0 = (self._done, self._counters,
                                         self._launches0)
            self._reset()
        done.sort(key=lambda x: x[0].host_start_ns)
        refs: dict = {}
        for rec, events in done:
            if events is None:
                continue
            start, end = events
            end.synchronize()
            ref = refs.setdefault(rec.device, start)
            rec.stream_start_ms = ref.elapsed_time(start)
            rec.stream_end_ms = ref.elapsed_time(end)
        records = [rec for rec, _ in done]
        launches = {}
        if launches0 is not None:
            launches = {k: n - launches0.get(k, 0)
                        for k, n in kernel_launches().items()}
        return {"spans": summarize(records), "counters": counters,
                "kernel_launches": launches, "records": records}


RECORDER = Recorder()


def span(name: str):
    """A span named `name` while a torch.profiler records, else a shared
    context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(RECORDER, name)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while a torch.profiler records."""
    if _autograd_profiler._is_profiler_enabled:
        RECORDER.count(name, n)


def take_report() -> dict:
    """The report of the period recorded since the last one (Recorder.
    take_report); call it after a device synchronize."""
    return RECORDER.take_report()


def kernel_launches() -> Dict[str, int]:
    """{kernel: CudaKernel.launches} of the kernels loaded so far ({}
    before diner_tpu_torch.kernels is imported)."""
    kernels = getattr(sys.modules.get("diner_tpu_torch.kernels"), "KERNELS",
                      {})
    return {k: v.launches for k, v in kernels.items()}


def covered(lo, hi, intervals: Sequence[Tuple]) -> float:
    """Length of [lo, hi] covered by the union of `intervals`."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def summarize(records: List[SpanRecord]) -> Dict[str, dict]:
    """{span name: {calls, no_parent (the calls opened with no span open
    on their thread), host_ms, host_self_ms, stream_ms, stream_self_ms}},
    totals over the records; the stream entries are None where no record
    of the name has stream times. A child counts against its parent's self
    time in the host clock, and in the stream clock where both have stream
    times on one device."""
    children = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            children[r.parent].append(r)
    table: Dict[str, dict] = {}
    for r in records:
        row = table.setdefault(r.name, {
            "calls": 0, "no_parent": 0, "host_ms": 0.0, "host_self_ms": 0.0,
            "stream_ms": None, "stream_self_ms": None})
        kids = children.get(r.id, ())
        row["calls"] += 1
        row["no_parent"] += r.parent is None
        host = r.host_end_ns - r.host_start_ns
        row["host_ms"] += host / 1e6
        row["host_self_ms"] += (host - covered(
            r.host_start_ns, r.host_end_ns,
            [(k.host_start_ns, k.host_end_ns) for k in kids])) / 1e6
        if r.stream_start_ms is None:
            continue
        stream = r.stream_end_ms - r.stream_start_ms
        inner = covered(r.stream_start_ms, r.stream_end_ms,
                        [(k.stream_start_ms, k.stream_end_ms) for k in kids
                         if k.stream_start_ms is not None
                         and k.device == r.device])
        row["stream_ms"] = (row["stream_ms"] or 0.0) + stream
        row["stream_self_ms"] = (row["stream_self_ms"] or 0.0) + stream - inner
    return table


def print_report(report: dict, n: int, unit: str) -> None:
    """Print a report's spans and counters per `unit` (request, step) over
    n of them."""
    print(f"spans: calls/{unit}; host ms/{unit} total, self; stream "
          f"ms/{unit} total, self")

    def ms(v):
        return "         -" if v is None else f"{v / n:10.3f}"

    for name, row in sorted(report["spans"].items(),
                            key=lambda x: -(x[1]["stream_ms"]
                                            or x[1]["host_ms"])):
        print(f"{row['calls'] / n:7.1f} {row['host_ms'] / n:10.3f} "
              f"{row['host_self_ms'] / n:10.3f} {ms(row['stream_ms'])} "
              f"{ms(row['stream_self_ms'])}  {name}"
              + (f" ({row['no_parent']} with no parent)"
                 if row["no_parent"] and row["no_parent"] < row["calls"]
                 else ""))
    print(f"counters /{unit}: " + ", ".join(
        f"{k} {v / n:g}" for k, v in sorted(report["counters"].items())))
    print(f"kernel launches /{unit}: " + ", ".join(
        f"{k} {v / n:g}" for k, v in sorted(
            report["kernel_launches"].items()) if v))


def report_json(report: dict, n: int, unit: str) -> dict:
    """A report's spans, counters and kernel launches, each per `unit`."""
    return {
        f"spans_per_{unit}": {
            name: {k: (v if k in ("calls", "no_parent") or v is None
                       else v / n) for k, v in row.items()}
            for name, row in report["spans"].items()},
        f"counters_per_{unit}": {k: v / n
                                 for k, v in report["counters"].items()},
        f"kernel_launches_per_{unit}": {
            k: v / n for k, v in report["kernel_launches"].items()}}


def card_name() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]


def device_intervals(prof) -> List[Tuple[int, int]]:
    """[start, end) ns of every kernel, copy and set on the device in a
    finished torch.profiler run. The device's mirror of a host annotation
    (a record_function's range on the device, under the same name) is left
    out."""
    from torch.autograd import DeviceType

    events = list(prof.profiler.kineto_results.events())
    host_names = {e.name() for e in events
                  if e.device_type() == DeviceType.CPU}
    out = []
    for e in events:
        if e.device_type() == DeviceType.CPU or e.name() in host_names:
            continue
        if hasattr(e, "activity_type"):
            kind = str(e.activity_type()).lower()
            if "annotation" in kind or not any(
                    k in kind for k in ("kernel", "memcpy", "memset")):
                continue
        out.append((e.start_ns(), e.end_ns()))
    return out


def device_tables(prof):
    """(operators, kernels, busy_us) of a finished torch.profiler run: rows
    (name, device us, calls) by device time, descending. Kernel rows
    (device events) carry each kernel's time once; operator rows (aten::*)
    carry the time of the kernels they launched. busy_us is the union of
    the device's kernel, copy and set intervals, so that two streams at
    once count once."""
    from torch.autograd import DeviceType

    def device_us(evt):
        return getattr(evt, "self_device_time_total",
                       getattr(evt, "self_cuda_time_total", 0.0))

    rows = [(e.key, device_us(e), e.count, e.device_type == DeviceType.CUDA)
            for e in prof.key_averages()]
    host_keys = {k for k, _, _, dev in rows if not dev}
    kernels = sorted(((k, us, c) for k, us, c, dev in rows
                      if dev and us > 0 and k not in host_keys),
                     key=lambda r: -r[1])
    operators = sorted(((k, us, c) for k, us, c, dev in rows
                        if not dev and us > 0), key=lambda r: -r[1])
    busy_ns = covered(float("-inf"), float("inf"), device_intervals(prof))
    return operators, kernels, busy_ns / 1e3


def print_tables(operators, kernels, busy_us, n: int, unit: str, top: int):
    """Print both tables per `unit` (request, step) over n of them."""
    for title, table in (("operators", operators), ("kernels", kernels)):
        print(f"{title}: device ms/{unit}, share of busy, calls/{unit}")
        for key, us, calls in table[:top]:
            print(f"{us / 1e3 / n:10.3f} {us / busy_us:6.3f} "
                  f"{calls / n:7.1f}  {key[:100]}")


def tables_json(operators, kernels, n: int, unit: str):
    return {title: [{"name": k, f"device_ms_per_{unit}": us / 1e3 / n,
                     f"calls_per_{unit}": c / n} for k, us, c in table]
            for title, table in (("operators", operators),
                                 ("kernels", kernels))}
