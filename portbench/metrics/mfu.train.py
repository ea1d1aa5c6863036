"""The circuit's counted flops a second of the traced training window, as a % of the peak."""
from portbench.frozen import readings


def read(record):
    return readings.mfu(record)
