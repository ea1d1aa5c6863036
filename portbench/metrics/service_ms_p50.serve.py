"""The median request's service time: its return less the start of its service (ms)."""
from portbench.frozen import readings


def read(record):
    return readings.service_ms_p50(record)
