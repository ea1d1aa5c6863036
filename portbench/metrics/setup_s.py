"""Seconds from the process's start to the first timed unit."""


def read(record):
    return record['setup_s']
