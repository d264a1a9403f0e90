"""Spans and counters at the port's layer boundaries, in memory, on the
clock of ``torch.profiler``'s Chrome trace.

    from rsoderh_raytracing_tpu_torch import tracing
    tracing.enable()              # device_events=True: CUDA events too
    renderer.step_freerun(64)
    rec = tracing.take()          # {"spans": [...], "counters": {...}}
    tracing.disable()

Off is the default. While off, ``span`` returns one shared no-op object
(no clock read, no allocation, no CUDA event, no sync) and ``count``
returns at once: the off path is one check of a module-level flag.

A span is a dict: ``name``, ``start`` and ``end`` (wall-clock
nanoseconds, the profiler's clock), ``id``, ``parent`` (the enclosing
span's id, None at a root), ``call`` (the root's id, shared by every span
of one call) and ``attrs``. Times are read with ``time.perf_counter_ns``
and converted in ``take`` through one (``time.time_ns``,
``perf_counter_ns``) pair read at the first ``enable``. A Chrome trace event of
``torch.profiler`` starts at ``ts * 1000 + baseTimeNanoseconds``
wall-clock nanoseconds, so the spans lie over an exported trace as they
are.

A span opened with ``events=True`` (``Wavefront.step``'s, on a card)
numbers its parts with ``part(name)``: each part is a child span that
ends where the next begins. Under ``enable(device_events=True)`` each
part boundary also records a CUDA event, and ``take`` gives each part
its ``device_ms`` (it waits for the last event).

Counters: ``sync.<site>`` counts each pass through a place where, on a
card, the host waits for the device (a read of a device value, a copy
between the host's pageable memory and the card); the set-up uploads are
inside the set-up spans instead. ``take`` reports beside them the kernel
launches of the wrappers while tracing was on (``launch.<wrapper>``: the
growth of ``ops/cuda_wavefront.LAUNCHES`` and
``ops/cuda_intersect.LAUNCHES``, which count whether tracing is on or
not).
"""

from __future__ import annotations

import collections
import functools
import itertools
import threading
import time

_on = False
_device_events = False
_clock = (0, 0)  # (time.time_ns(), time.perf_counter_ns()) read at enable
_spans: list = []
_counts: collections.Counter = collections.Counter()
_launch_base: dict = {}
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of a disabled tracer: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def part(self, name):
        pass


OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("rec", "events", "open_part", "mark")

    def __init__(self, name, attrs, events=False):
        self.rec = dict(name=name, start=0, end=0, id=next(_ids), parent=None, call=None,
                        attrs=attrs)
        self.events = events and _device_events
        self.open_part = None
        self.mark = None

    def __enter__(self):
        stack = _stack()
        rec = self.rec
        if stack:
            top = stack[-1].rec
            rec["parent"], rec["call"] = top["id"], top["call"]
        else:
            rec["call"] = rec["id"]
        stack.append(self)
        rec["start"] = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.open_part is not None:
            self.part(None)
        self.rec["end"] = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        _spans.append(self.rec)
        return False

    def part(self, name):
        """End the part this span has open, if any, and open the part
        `name` (None: none) as a child span."""
        mark = None
        if self.events:
            import torch

            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
        if self.open_part is not None:
            sub = self.open_part
            sub.rec["end"] = time.perf_counter_ns()
            if mark is not None:
                sub.rec["events"] = (sub.mark, mark)
            _spans.append(sub.rec)
            self.open_part = None
        if name is not None:
            sub = _Span(name, {})
            sub.rec["parent"], sub.rec["call"] = self.rec["id"], self.rec["call"]
            sub.mark = mark
            sub.rec["start"] = time.perf_counter_ns()
            self.open_part = sub


def span(name: str, events: bool = False, **attrs):
    """A context manager that records the span `name` with `attrs` while
    tracing is on (the shared no-op OFF otherwise). events=True lets its
    parts record CUDA events under enable(device_events=True)."""
    if not _on:
        return OFF
    return _Span(name, attrs, events)


def traced(name: str):
    """Decorator: each call of the function is the span `name` while
    tracing is on (for the set-up functions)."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name, {}):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    if _on:
        _counts[name] += n


def _launches() -> dict:
    from rsoderh_raytracing_tpu_torch.ops import cuda_intersect, cuda_wavefront

    return {**cuda_wavefront.LAUNCHES, **cuda_intersect.LAUNCHES}


def _count_launches() -> None:
    """Add the launches since the last reading to the counters."""
    global _launch_base
    now = _launches()
    for k, v in now.items():
        base = _launch_base.get(k, 0)
        n = v - base if v >= base else v  # reset_launches() ran between
        if n:
            _counts[f"launch.{k}"] += n
    _launch_base = now


def enable(device_events: bool = False) -> None:
    """Start recording (device_events: part boundaries record CUDA
    events). The clock pair is read the first time; enabling again changes
    only device_events."""
    global _on, _device_events, _clock, _launch_base
    _device_events = bool(device_events)
    if _on:
        return
    if _clock == (0, 0):
        _clock = (time.time_ns(), time.perf_counter_ns())
    _launch_base = _launches()
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays for take()."""
    global _on
    if _on:
        _count_launches()
    _on = False


def take() -> dict:
    """{"spans": [...], "counters": {...}} recorded since the last take,
    in the order the spans ended, times in wall-clock nanoseconds; clears
    them. Parts with CUDA events get device_ms (take waits for them)."""
    if _on:
        _count_launches()
    wall, perf = _clock
    spans = _spans[:]
    del _spans[:len(spans)]
    for rec in spans:
        events = rec.pop("events", None)
        if events is not None:
            events[1].synchronize()
            rec["device_ms"] = events[0].elapsed_time(events[1])
        rec["start"] += wall - perf
        rec["end"] += wall - perf
    counters = dict(_counts)
    _counts.clear()
    return {"spans": spans, "counters": counters}
