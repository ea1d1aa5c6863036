"""Mean host ms of an epoch's ``solver.host_read``: the host's wait for the
card at the epoch's one read (traced run).  Read beside
host_ms_per_step.train: it falls when the card speeds up, rises when the
host does."""
from portbench.frozen import spans


def read(record):
    return spans.host_ms_per('solver.host_read')
