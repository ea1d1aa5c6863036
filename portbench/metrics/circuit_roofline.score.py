"""The circuit's least time over the card's busy time, scoring (%)."""
from portbench.frozen import readings


def read(record):
    return readings.circuit_roofline(record)
