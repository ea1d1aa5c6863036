"""
Per-layer readings from the program's own spans (``quanonet_torch.tracing``):
the record of the traced run's profiler session, which holds the window and
the one warm unit the harness runs before it.  A reading with nothing to
read is None, never 0: no session, a program without the registry, a span
that never ran, or no device time (on the CPU).
"""
from portbench.frozen import work


def _spans():
    try:
        from quanonet_torch import tracing
    except ImportError:
        return {}
    return tracing.snapshot()['spans']


def host_ms_per(name, per=None):
    """Mean host ms of span ``name`` a call of span ``per`` (default:
    ``name`` itself)."""
    spans = _spans()
    span, calls = spans.get(name), spans.get(per or name)
    if not span or not calls:
        return None
    return 1e3 * span['host_s'] / calls['count']


def device_ms_per_call(name):
    """Mean device ms of span ``name`` a call: its CUDA events' time."""
    span = _spans().get(name)
    if not span or not span['device_s']:
        return None
    return 1e3 * span['device_s'] / span['count']


def chain_roofline(record, name, passes):
    """% : the circuit's least time for the rows that span ``name`` counted,
    over the span's device seconds.  A row's forward work is the window's
    (flops and bytes over its rows, over 3 passes in training); the chain
    does ``passes`` of it (1 forward, 2 backward)."""
    span = _spans().get(name)
    if not span or not span['device_s'] or not span['rows'] \
            or not record.get('rows'):
        return None
    share = (span['rows'] / record['rows'] * passes
             / (3 if record['kind'] == 'train' else 1))
    least = work.least_seconds(share * record['flops'],
                               share * record['bytes'])
    return 100 * least / span['device_s']
