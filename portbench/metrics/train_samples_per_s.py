"""Training rows stepped in the window over its seconds (the window ends
with a synchronise)."""


def read(record):
    return record['rows'] / record['seconds']
