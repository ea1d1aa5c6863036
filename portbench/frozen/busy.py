"""
What the card did in a traced window, read from torch.profiler's raw
events: its own rows (kernels, copies, sets), the union of their
intervals, and the host's work in the gaps between them.

Copied from ``quanonet_torch/profile_step._device_rows``, with two
changes: the busy time is the union of the rows' intervals, not the sum
of their durations (rows on two streams would count twice), and the
window is the span the harness marks, not a few calls.
"""
import numpy as np
from torch.autograd import DeviceType

WINDOW_SPAN = 'portbench.window'


def _is_annotation(event):
    annotation = getattr(event, 'is_user_annotation', None)
    return annotation is not None and annotation()


def split_events(events):
    """(window, device rows, host ops) of a trace: the (start, end) ns of
    the harness's window span, the card's rows as (start, end, name) and
    the host's ops and spans as (start, end, name)."""
    window, device, host = None, [], []
    for e in events:
        start, dur = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e):
                device.append((start, start + dur, e.name()))
            continue
        if e.name() == WINDOW_SPAN:
            window = (start, start + dur)
        else:
            host.append((start, start + dur, e.name()))
    return window, device, host


def merge(intervals):
    """The union of (start, end, ...) intervals as sorted, disjoint
    [start, end] pairs."""
    merged = []
    for start, end, *_ in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def clip(rows, window):
    """The rows that overlap the window, cut to it."""
    w0, w1 = window
    return [(max(s, w0), min(e, w1), *rest) for s, e, *rest in rows
            if e > w0 and s < w1]


def busy_ns(rows, window):
    """The card's busy time in the window: the union of its rows."""
    return sum(e - s for s, e in merge(clip(rows, window)))


def top_device_ops(rows, window, k=10):
    """[[name, seconds], ...]: the k rows' names that took most card time
    in the window, by the sum of their (clipped) durations."""
    total = {}
    for s, e, name in clip(rows, window):
        total[name] = total.get(name, 0) + (e - s)
    top = sorted(total.items(), key=lambda kv: kv[1], reverse=True)[:k]
    return [[name, ns / 1e9] for name, ns in top]


def _host_at(starts, ends, names, t):
    """The innermost host op or span running at time t, or 'idle host'."""
    hit = np.flatnonzero((starts <= t) & (ends > t))
    if not hit.size:
        return 'idle host'
    return names[hit[np.argmin(ends[hit] - starts[hit])]]


def idle_gaps(rows, host, window, k=10):
    """[[host op, seconds], ...]: the k longest stretches of the window in
    which the card ran nothing, each named by the innermost host op
    running at its middle."""
    w0, w1 = window
    gaps, at = [], w0
    for s, e in merge(clip(rows, window)):
        if s > at:
            gaps.append((s - at, at, s))
        at = max(at, e)
    if w1 > at:
        gaps.append((w1 - at, at, w1))
    gaps = sorted(gaps, reverse=True)[:k]
    starts = np.array([h[0] for h in host], np.int64)
    ends = np.array([h[1] for h in host], np.int64)
    names = [h[2] for h in host]
    return [[_host_at(starts, ends, names, (a + b) // 2), ns / 1e9]
            for ns, a, b in gaps]


def summarize(events):
    """The traced window's numbers: its length, the card's busy time (a
    union), its row count, the top device ops and the longest idle gaps."""
    window, device, host = split_events(events)
    if window is None:
        raise RuntimeError(f"no '{WINDOW_SPAN}' span in the trace")
    rows = clip(device, window)
    return {
        'window_s': (window[1] - window[0]) / 1e9,
        'busy_s': busy_ns(device, window) / 1e9,
        'device_rows': len(rows),
        'device_ops': top_device_ops(device, window),
        'idle_gaps': idle_gaps(device, host, window),
    }
