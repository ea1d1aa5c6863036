"""Mean host ms a training step in ``solver.optimizer``: the optimizer's
zero_grad and step (traced run)."""
from portbench.frozen import spans


def read(record):
    return spans.host_ms_per('solver.optimizer', per='solver.step')
