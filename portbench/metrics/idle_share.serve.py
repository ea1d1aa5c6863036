"""The share of the traced serving window in which the card ran nothing (%)."""
from portbench.frozen import readings


def read(record):
    return readings.idle_share(record)
