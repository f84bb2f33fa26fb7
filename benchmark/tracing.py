"""What a traced run records, from the benchmark's own files, around the
calls into each layer of the port:

- CUDA events around every call of a kernel wrapper (``flops.kernels.
  WRAPPERS``: the function that enqueues each kernel on a CUDA tensor),
  with that call's bound from its shapes;
- CUDA events around named spans: a module's forward (forward pre- and
  post-hooks) or a function of the program (the optimizer update);
- torch.profiler over the same units: every kernel on the device, and the
  host's operations, for the launch count, the busy and idle time and the
  breakdown.

Nothing is recorded outside ``Tracer.active``; without a traced run the
tracer is never built.
"""
from __future__ import annotations

import collections
import sys
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark.flops import kernels as kflops

_MEMORY_OPS = ("Memcpy", "Memset", "memcpy", "memset")


class Tracer:
    def __init__(self, device):
        self.device = device
        self.active = False
        self.calls: List[tuple] = []  # (key, start event, end event, bound seconds or None)
        self.spans: Dict[str, List[tuple]] = collections.defaultdict(list)
        self._open: Dict[str, torch.cuda.Event] = {}
        self._restore: List[tuple] = []
        self._handles = []
        self.prof = None
        self.window_s = 0.0
        self.units = 0

    # -- hooks ---------------------------------------------------------------
    def _event(self) -> torch.cuda.Event:
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def install_wrappers(self) -> None:
        """Time every call of each kernel wrapper, wherever the program's
        modules hold it (by identity of the function object)."""
        targets = {}
        for key, (mod_name, fn_name, cost) in kflops.WRAPPERS.items():
            mod = sys.modules.get(mod_name)
            fn = getattr(mod, fn_name, None) if mod is not None else None
            if fn is not None:
                targets[id(fn)] = (key, fn, cost)
        for mod_name, mod in list(sys.modules.items()):
            if not mod_name.startswith("synchformer_tpu_torch") or mod is None:
                continue
            for attr, value in list(vars(mod).items()):
                hit = targets.get(id(value))
                if hit is not None:
                    self._restore.append((mod, attr, value))
                    setattr(mod, attr, self._timed(*hit))

    def _timed(self, key: str, fn: Callable, cost) -> Callable:
        tracer = self

        def timed(*args, **kwargs):
            if not tracer.active:
                return fn(*args, **kwargs)
            start = tracer._event()
            out = fn(*args, **kwargs)
            end = tracer._event()
            try:  # the bookkeeping never breaks the program's call
                bound = kflops.bound_s(*cost(args, kwargs))
            except (IndexError, KeyError, AttributeError, ValueError, TypeError):
                bound = None
            tracer.calls.append((key, start, end, bound))
            return out

        return timed

    def span_module(self, name: str, module: torch.nn.Module) -> None:
        """A span over each forward of ``module``."""
        def pre(_mod, _args):
            if self.active:
                self._open[name] = self._event()

        def post(_mod, _args, _out):
            if self.active and name in self._open:
                self.spans[name].append((self._open.pop(name), self._event()))

        self._handles.append(module.register_forward_pre_hook(pre))
        self._handles.append(module.register_forward_hook(post))

    def span_function(self, name: str, module, attr: str, after: Optional[str] = None) -> None:
        """A span over each call of ``module.attr``; with ``after``, also a
        span named so from the end of the open span ``after``'s last event
        to this call's start."""
        fn = getattr(module, attr)
        tracer = self

        def spanned(*args, **kwargs):
            if not tracer.active:
                return fn(*args, **kwargs)
            start = tracer._event()
            if after is not None and tracer.spans.get(after):
                tracer.spans[f"{after}->{name}"].append((tracer.spans[after][-1][1], start))
            out = fn(*args, **kwargs)
            tracer.spans[name].append((start, tracer._event()))
            return out

        self._restore.append((module, attr, fn))
        setattr(module, attr, spanned)

    def remove(self) -> None:
        for mod, attr, value in reversed(self._restore):
            setattr(mod, attr, value)
        self._restore.clear()
        for h in self._handles:
            h.remove()
        self._handles.clear()

    # -- the traced units ------------------------------------------------------
    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.active = True
        self._t0 = time.perf_counter()

    def stop(self, units: int) -> None:
        torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self._t0
        self.active = False
        self.prof.stop()
        self.units = units

    def results(self) -> dict:
        """The trace read out: kernels (name, start us, end us), host
        operations, wrapper calls (key, ms, bound s) and spans (name -> ms
        per call)."""
        kernels, host = _profiler_events(self.prof)
        calls = [(key, s.elapsed_time(e), bound) for key, s, e, bound in self.calls]
        spans = {name: [s.elapsed_time(e) for s, e in pairs] for name, pairs in self.spans.items()}
        return {"kernels": kernels, "host": host, "calls": calls, "spans": spans,
                "window_s": self.window_s, "units": self.units}


def _profiler_events(prof):
    """Device kernels and host operations as (name, start us, end us),
    memory copies and sets left out of the kernels."""
    kernels, host = [], []
    try:
        raw = prof.profiler.kineto_results.events()
        for e in raw:
            start = e.start_ns() / 1e3
            end = start + e.duration_ns() / 1e3
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if not name.startswith(_MEMORY_OPS):
                    kernels.append((name, start, end))
            else:
                host.append((name, start, end))
    except AttributeError:
        for e in prof.events():
            start, end = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith(_MEMORY_OPS):
                    kernels.append((e.name, start, end))
            else:
                host.append((e.name, start, end))
    kernels.sort(key=lambda k: k[1])
    return kernels, host


def busy_us(kernels) -> float:
    """The union of the kernels' intervals, in microseconds."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in kernels:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time (name, seconds) and the
    longest idle gaps between kernels, named by the innermost host
    operation running at the gap's middle (name, seconds)."""
    kernels = trace["kernels"]
    by_name = collections.Counter()
    for name, s, e in kernels:
        by_name[name[:120]] += (e - s) / 1e6
    gaps, cur_e = [], None
    for _, s, e in kernels:
        if cur_e is not None and s > cur_e:
            gaps.append((s - cur_e, cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    gaps.sort(reverse=True)
    named = []
    for length, s, e in gaps[:top]:
        mid = (s + e) / 2
        inner = [(he - hs, name) for name, hs, he in trace["host"] if hs <= mid <= he]
        label = min(inner)[1] if inner else "no host operation"
        named.append([f"host: {label[:110]}", length / 1e6])
    return {"device_ops": [[n, sec] for n, sec in by_name.most_common(top)],
            "idle_gaps": named}
