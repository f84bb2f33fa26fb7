"""The port's own spans and counters, stamped on torch.profiler's clock.

    from synchformer_tpu_torch.utils import trace

    with trace.span("step", unit=step, device=device):   # a unit's root
        with trace.span("step.forward"):
            ...
        trace.count("host_syncs", 4)

    with trace.recording():          # record without the profiler
        trainer.train_step(batch)
    records = trace.spans()          # dicts, host interval in µs, stream ms

Recording is on while torch.profiler records (``torch.autograd.
_profiler_enabled()``) or inside ``recording()``; off, ``span`` returns the
shared no-op ``NOOP`` and ``count`` returns at once: no record, no CUDA event,
one flag check and the profiler-state call. A span is never a
``record_function`` range and pushes nothing to NVTX: the profiler's trace
holds the program's kernels and host operations alone, and the spans lie
beside it on its clock.

A span records its name, its parent (the innermost span open on its thread;
on a thread with none open, such as autograd's device thread running a
backward, the innermost span open on the thread that opened the current
unit, unless the span is itself a unit's root), the unit it belongs to (given to the unit's root as ``unit``: the
predictor's call index, the trainer's step; its descendants share it), its
attributes, its host start and end (``time.perf_counter_ns``) and, where the
unit runs on a CUDA device (the root's ``device``), a pair of timing CUDA
events on the current stream for its stream milliseconds. ``count`` adds to a
counter of the innermost open span's unit (``host_syncs``: each host-device
synchronisation the program forces, counted at its site).

Each recording session starts a new record: ``recording()``, or the first
span recorded under the profiler after a unit's root opened with recording
off. It holds at most ``MAX_SPANS`` spans; the spans past that are counted in
``dropped()``, not raised. Reading does not clear it. ``spans()`` converts
the host intervals to the profiler's clock, the Unix epoch in µs (kineto's
``start_ns`` / 1e3), through one anchor pair (``time.time_ns()``,
``time.perf_counter_ns()``) taken when the session starts.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Dict, List, Optional

import torch

MAX_SPANS = 1 << 17

_profiler_enabled = torch.autograd._profiler_enabled


class _Noop:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Session:
    """One recording session: its anchor, spans, counters and thread stacks."""

    def __init__(self):
        self.epoch_ns = time.time_ns()
        self.perf_ns = time.perf_counter_ns()
        self.spans: List["_Span"] = []
        self.counts: Dict[tuple, int] = {}
        self.dropped = 0
        self.local = threading.local()
        self.owner: Optional[list] = None  # the stack of the thread holding the open unit
        self.lock = threading.Lock()

    def stack(self) -> list:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def innermost(self, stack: list) -> Optional["_Span"]:
        if stack:
            return stack[-1]
        owner = self.owner
        return owner[-1] if owner else None


class _Span:
    __slots__ = ("session", "name", "attrs", "unit", "device", "parent", "stack", "index",
                 "t0", "t1", "ev0", "ev1", "cuda")

    def __init__(self, session: _Session, name: str, unit, device, attrs: dict):
        self.session, self.name, self.attrs = session, name, attrs
        self.unit, self.device = unit, device

    def __enter__(self):
        s = self.session
        stack = s.stack()
        # a unit's root opened on a thread with no open span starts a tree
        parent = self.parent = None if self.unit is not None and not stack else s.innermost(stack)
        if self.unit is None and parent is not None:
            self.unit = parent.unit
        if self.device is not None:
            self.cuda = torch.device(self.device).type == "cuda"
        else:
            self.cuda = parent is not None and parent.cuda
        if not stack and s.owner is None and self.unit is not None:
            s.owner = stack
        self.stack = stack
        stack.append(self)
        if len(s.spans) < MAX_SPANS:
            self.index = len(s.spans)
            s.spans.append(self)
        else:
            self.index = -1
            s.dropped += 1
        self.t1 = self.ev1 = None
        if self.cuda and self.index >= 0:
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        else:
            self.ev0 = None
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self.ev0 is not None:
            self.ev1 = torch.cuda.Event(enable_timing=True)
            self.ev1.record()
        stack = self.stack
        if stack and stack[-1] is self:
            stack.pop()
        s = self.session
        if s.owner is stack and not stack:
            s.owner = None
        return False


_forced = False  # inside recording()
_live = False  # a session is being recorded into
_session: Optional[_Session] = None


def _current() -> _Session:
    global _session, _live
    if not _live:
        _session, _live = _Session(), True
    return _session


def span(name: str, unit=None, device=None, **attrs):
    """A context manager recording one span while recording is on (else
    ``NOOP``). ``unit`` makes it a unit's root; ``device`` (a root's) says
    whether the unit's work is on a CUDA device, for stream milliseconds."""
    global _live
    if _forced or _profiler_enabled():
        return _Span(_current(), name, unit, device, attrs)
    if _live and unit is not None:  # a unit opens with recording off: the session is over
        _live = False
    return NOOP


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the innermost open span's unit
    (None outside every unit) while recording is on."""
    if _forced or _profiler_enabled():
        s = _current()
        inner = s.innermost(s.stack())
        key = (name, None if inner is None else inner.unit)
        with s.lock:
            s.counts[key] = s.counts.get(key, 0) + n


@contextlib.contextmanager
def recording():
    """Record spans and counters without torch.profiler: a new session for
    the body of the ``with``."""
    global _forced, _session, _live
    _session, _live, _forced = _Session(), True, True
    try:
        yield
    finally:
        _forced = _live = False


def spans() -> List[dict]:
    """The newest session's closed spans in the order they opened: ``id``
    (their index), ``name``, ``parent`` (an id, or None), ``unit``,
    ``start_us`` / ``end_us`` on the profiler's clock, ``stream_ms`` (None
    without CUDA events) and ``attrs``."""
    s = _session
    if s is None:
        return []
    shift = s.epoch_ns - s.perf_ns
    out = []
    for sp in list(s.spans):
        if sp.t1 is None:
            continue
        stream_ms = None
        if sp.ev1 is not None:
            sp.ev1.synchronize()
            stream_ms = sp.ev0.elapsed_time(sp.ev1)
        parent = sp.parent
        out.append({"id": sp.index, "name": sp.name,
                    "parent": parent.index if parent is not None and parent.index >= 0 else None,
                    "unit": sp.unit, "start_us": (sp.t0 + shift) / 1e3,
                    "end_us": (sp.t1 + shift) / 1e3, "stream_ms": stream_ms,
                    "attrs": dict(sp.attrs)})
    return out


def counts(name: str) -> Dict[object, int]:
    """Counter ``name`` of the newest session, by unit."""
    s = _session
    if s is None:
        return {}
    with s.lock:
        return {unit: n for (key, unit), n in s.counts.items() if key == name}


def dropped() -> int:
    """The spans the newest session left out past ``MAX_SPANS``."""
    return 0 if _session is None else _session.dropped


def write_jsonl(path) -> int:
    """The newest session's spans, one JSON object a line, then one line
    ``{"counts": ..., "dropped": ...}``; returns the number of spans."""
    records = spans()
    s = _session
    with open(path, "w") as f:
        for r in records:
            f.write(json.dumps(r, default=str) + "\n")
        tallies = {} if s is None else {f"{k}@{u}": n for (k, u), n in s.counts.items()}
        f.write(json.dumps({"counts": tallies, "dropped": dropped()}) + "\n")
    return len(records)
