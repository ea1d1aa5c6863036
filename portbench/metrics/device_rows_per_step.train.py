"""The card's rows a training step, in the traced window."""
from portbench.frozen import readings


def read(record):
    return readings.rows_per_unit(record)
