"""Mean card ms of a scored chunk's operand build: the ``circuit.operands``
span (block matrices and phases), one a chunk's forward (traced run)."""
from portbench.frozen import spans


def read(record):
    return spans.device_ms_per_call('circuit.operands')
