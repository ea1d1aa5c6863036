"""The share of the traced training window in which the card ran nothing (%)."""
from portbench.frozen import readings


def read(record):
    return readings.idle_share(record)
