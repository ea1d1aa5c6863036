"""The circuit's least time for the chain's backward rows (twice the
forward's work) over the card's time in ``circuit.chain_bwd`` spans,
training (%)."""
from portbench.frozen import spans


def read(record):
    return spans.chain_roofline(record, 'circuit.chain_bwd', 2)
