"""The circuit's least time for the chain's forward rows over the card's
time in ``circuit.chain_fwd`` spans, scoring (%)."""
from portbench.frozen import spans


def read(record):
    return spans.chain_roofline(record, 'circuit.chain_fwd', 1)
