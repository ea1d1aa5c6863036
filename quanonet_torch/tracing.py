"""
Spans and counters of the port, in one registry.

A span marks a stretch of the program's work at a layer boundary (the
Solver's step and its phases, the circuit's operand build and chain); a
counter counts events where they happen (each kernel wrapper's launches,
under the keys of ``profile_step.launch_counts``)::

    with tracing.span('solver.step', rows=batch):
        ...
    tracing.count('hea_chain_fwd')

Tracing is on while a ``torch.profiler`` session records, or inside
``with tracing.enabled():`` (for tools and operators who want the numbers
without a profiler).  Off, :func:`span` returns one shared no-op and
records nothing.  Counters always count.

On, a span:

* enters ``torch.profiler.record_function(name)`` under a profiler, so
  that it sits in the profiler's trace on the card's clock;
* records its host start and end (a monotonic clock), its parent span from
  a per-thread stack (on CUDA, autograd runs the backward on a thread of
  its own, so a span there has no parent), and its ``rows`` where given;
* with ``device=True``, records a pair of CUDA events on the current
  stream.  Their time is read without a synchronise as they complete, the
  rest at :func:`snapshot`.  It is the stream's time from the span's start
  to its end, gaps in which the card waited for the host included.

The record starts anew each time a profiler session starts (or the
outermost ``enabled()`` is entered outside one), and stays readable after
it ends, until the next.  It is kept in memory; the profiler's chrome
trace is its export.
"""
import collections
import threading
import time
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _profiler


class _Noop:
    """The span returned while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Stats:
    """One span name's totals over its calls."""
    __slots__ = ('count', 'host_s', 'self_s', 'device_s', 'rows', 'parents')

    def __init__(self):
        self.count, self.host_s, self.self_s = 0, 0.0, 0.0
        self.device_s = self.rows = None
        self.parents = collections.Counter()

    def as_dict(self):
        return {'count': self.count, 'host_s': self.host_s,
                'self_s': self.self_s, 'device_s': self.device_s,
                'rows': self.rows, 'parents': dict(self.parents)}


class _Span:
    __slots__ = ('reg', 'name', 'rows', 'device', 'parent', 'children_s',
                 'rf', 'events', 't0')

    def __init__(self, reg, name, rows, device):
        self.reg, self.name, self.rows, self.device = reg, name, rows, device
        self.children_s = 0.0
        self.rf = self.events = None

    def __enter__(self):
        stack = self.reg.stack()
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        if self.device:
            self.events = self.reg.event_pair()
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        host = time.perf_counter() - self.t0
        if self.events:
            self.events[1].record()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = self.reg.stack()
        stack.pop()
        if stack:
            stack[-1].children_s += host
        self.reg.add(self, host)
        return False


class Registry:
    """Spans and counters; the module's functions act on one instance."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._counts = collections.Counter()
        self._spans = {}
        self._pending = collections.deque()   # (stats, start, end) events
        self._free = []                       # resolved events, reused
        self._depth = 0

    def on(self):
        return bool(self._depth or _profiler._is_profiler_enabled)

    def span(self, name, rows=None, device=False):
        """A context manager over the work it encloses; the shared no-op
        while tracing is off."""
        if not (self._depth or _profiler._is_profiler_enabled):
            return _NOOP
        return _Span(self, name, rows, device)

    @contextmanager
    def enabled(self):
        """Tracing on without a profiler, for the enclosed work."""
        if not self.on():
            self.restart()
        with self._lock:
            self._depth += 1
        try:
            yield
        finally:
            with self._lock:
                self._depth -= 1

    def count(self, name, n=1):
        with self._lock:
            self._counts[name] += n

    def counts(self):
        """A copy of the counters (0 for a name never counted)."""
        with self._lock:
            return collections.Counter(self._counts)

    def restart(self):
        """Forgets the spans (a new session starts)."""
        with self._lock:
            self._spans.clear()
            self._pending.clear()

    def reset(self):
        """Forgets the spans and zeroes the counters."""
        self.restart()
        with self._lock:
            self._counts.clear()

    def snapshot(self):
        """{'spans': {name: {count, host_s, self_s, device_s, rows,
        parents}}, 'counters': {name: n}}: host and self seconds summed over
        the calls, device seconds None where no CUDA event was recorded,
        rows summed (None where never given), parents {parent name or None:
        calls}.  Waits for the card to reach the spans' last events."""
        with self._lock:
            self._resolve(block=True)
            return {'spans': {k: v.as_dict() for k, v in self._spans.items()},
                    'counters': dict(self._counts)}

    # ── internals

    def stack(self):
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def event_pair(self):
        with self._lock:
            if len(self._free) >= 2:
                return self._free.pop(), self._free.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def add(self, sp, host):
        with self._lock:
            st = self._spans.get(sp.name)
            if st is None:
                st = self._spans[sp.name] = _Stats()
            st.count += 1
            st.host_s += host
            st.self_s += host - sp.children_s
            st.parents[sp.parent] += 1
            if sp.rows is not None:
                st.rows = (st.rows or 0) + sp.rows
            if sp.events:
                self._pending.append((st, *sp.events))
            self._resolve(block=False)

    def _resolve(self, block):
        """Adds the device time of the completed event pairs, in order;
        with ``block`` waits for all."""
        while self._pending:
            st, start, end = self._pending[0]
            if block:
                end.synchronize()
            elif not end.query():
                return
            self._pending.popleft()
            st.device_s = (st.device_s or 0.0) + start.elapsed_time(end) / 1e3
            self._free += (start, end)


_registry = Registry()
span = _registry.span
enabled = _registry.enabled
count = _registry.count
counts = _registry.counts
reset = _registry.reset
snapshot = _registry.snapshot


def _start_anew_with_each_session():
    """Makes each profiler session start the record anew: wraps the hook
    that torch's profiler runs as a session starts."""
    start = _profiler._run_on_profiler_start
    if getattr(start, 'restarts_tracing', False):
        return

    def run_on_profiler_start():
        start()
        _registry.restart()
    run_on_profiler_start.restarts_tracing = True
    _profiler._run_on_profiler_start = run_on_profiler_start


_start_anew_with_each_session()
