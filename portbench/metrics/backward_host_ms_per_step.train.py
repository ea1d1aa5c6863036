"""Mean host ms a training step in ``solver.backward``: the host's enqueue
of autograd's backward (traced run)."""
from portbench.frozen import spans


def read(record):
    return spans.host_ms_per('solver.backward', per='solver.step')
