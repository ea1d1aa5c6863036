"""
The arithmetic of the per-layer metrics, from a window's record (see
portbench/harness.py).  A reading with nothing to read is None, never 0.
"""
import numpy as np

from portbench.frozen import work


def _traced(record):
    return record.get('busy_s', 0) > 0 and record.get('window_s', 0) > 0


def idle_share(record):
    """% of the traced window in which the card ran nothing."""
    if not _traced(record):
        return None
    return 100 * (record['window_s'] - record['busy_s']) / record['window_s']


def rows_per_unit(record):
    """The card's rows (kernels, copies, sets) a unit of the window."""
    if not _traced(record) or not record['units']:
        return None
    return record['device_rows'] / record['units']


def mfu(record):
    """% of the peak that the circuit's counted flops take over the whole
    traced window."""
    if not _traced(record):
        return None
    return 100 * record['flops'] / (record['window_s'] * work.PEAK_FLOPS)


def circuit_roofline(record):
    """% of the card's busy time that the circuit's least time takes."""
    if not _traced(record):
        return None
    least = work.least_seconds(record['flops'], record['bytes'])
    return 100 * least / record['busy_s']


def service_ms_p50(record):
    """The median request's time from the start of its service to its
    return."""
    if not record.get('service_ms'):
        return None
    return float(np.median(record['service_ms']))
