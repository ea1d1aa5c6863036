"""Rows scored in the window over its seconds (each pass ends in its copy
to the host)."""


def read(record):
    return record['rows'] / record['seconds']
