"""Mean host ms of a training step: the Solver's ``solver.step`` span, from
the batch's gather to the optimizer's return (traced run)."""
from portbench.frozen import spans


def read(record):
    return spans.host_ms_per('solver.step')
